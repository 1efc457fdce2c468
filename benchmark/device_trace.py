"""Reading the traced window: device busy time, kernel time by name, and
where the cards sat idle.

The window runs under ``torch.profiler`` (CPU and CUDA activity, every
card).  Its raw events give each device operation's interval; the busy
time of a card is the union of those intervals inside the window (so
overlapping streams are not counted twice).  Each idle gap is named by
what the host was doing over it: the innermost open range of
the program's spans (``alac.*``) or the harness's own (``bench.*``).
Origin of the approach: ``utils/observability.profile_busy`` of the port
(summed device time over the wall), here with intervals so that the
busy share and the gaps come from one reading.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

#: The host ranges that name an idle gap: the program's and the harness's.
SPAN_PREFIXES = ("alac.", "bench.")
WINDOW_SPAN = "bench.window"
TOP = 10


@dataclasses.dataclass
class TraceData:
    window_s: float
    #: busy seconds per card (union of its device intervals in the window)
    busy_by_card: dict
    #: summed device time per operation name (kernels, copies, fills)
    op_seconds: dict
    #: the idle seconds of the cards, averaged over them, by host activity
    idle_by_activity: dict

    @property
    def busy_s(self) -> float:
        return sum(self.busy_by_card.values()) / max(1, len(self.busy_by_card))

    def idle_pct(self) -> float | None:
        """The share of the window in which no operation ran on the cards,
        in %, averaged over them; None where none ran."""
        if not self.busy_s:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, *parts: str) -> float:
        """Summed device time of the operations whose names hold every part."""
        return sum(s for name, s in self.op_seconds.items() if all(p in name for p in parts))

    def breakdown(self) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_activity.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read(prof, cards: list) -> TraceData | None:
    """Summarise a finished ``torch.profiler.profile`` whose window was
    opened as a ``bench.window`` range; ``cards`` are the device indices
    the cell uses.  None when the trace holds no window range.  A range
    (``record_function``) also shows on the device's timeline, as a user
    annotation over the kernels it launched: it is no device work."""
    events = prof.profiler.kineto_results.events()
    window = None
    host, device = [], collections.defaultdict(list)
    op_seconds = collections.Counter()
    for ev in events:
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            if _annotation(ev):
                continue
            s = ev.start_ns()
            device[ev.device_index()].append((s, s + ev.duration_ns()))
            op_seconds[name] += ev.duration_ns() / 1e9
        elif name == WINDOW_SPAN:
            window = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        elif name.startswith(SPAN_PREFIXES):
            host.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name))
    if window is None:
        return None
    w0, w1 = window
    segments = _innermost(host)
    starts = [g[0] for g in segments]
    busy, gaps = {}, collections.Counter()
    for card in cards:
        merged = [(max(s, w0), min(e, w1)) for s, e in _union(device.get(card, []))]
        merged = [(s, e) for s, e in merged if e > s]
        busy[card] = sum(e - s for s, e in merged) / 1e9
        edges = [w0] + [x for se in merged for x in se] + [w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            for name, ns in _attribute(segments, starts, g0, g1):
                gaps[name] += ns / 1e9 / len(cards)
    return TraceData((w1 - w0) / 1e9, busy, dict(op_seconds), dict(gaps))


def _annotation(ev) -> bool:
    try:
        return bool(ev.is_user_annotation()) or "annotation" in str(ev.activity_type())
    except AttributeError:
        return False


def _innermost(host):
    """The host's time as sorted (start, end, name) segments, each named by
    the innermost range open over it (ranges on one thread nest)."""
    segments, stack = [], []
    cur = None

    def upto(t):
        nonlocal cur
        if stack and cur is not None and t > cur:
            segments.append((cur, t, stack[-1][1]))
        cur = t if cur is None else max(cur, t)

    for s, e, name in sorted(host, key=lambda h: (h[0], -h[1])):
        while stack and stack[-1][0] <= s:
            upto(stack[-1][0])
            stack.pop()
        upto(s)
        stack.append((e, name))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    return segments


def _attribute(segments, starts, g0, g1):
    """(name, ns) of the idle interval [g0, g1) by the host segments over
    it; what no segment covers is "outside any span"."""
    out, covered = [], 0
    i = max(0, bisect.bisect_right(starts, g0) - 1)
    while i < len(segments) and segments[i][0] < g1:
        s, e, name = segments[i]
        ov = min(e, g1) - max(s, g0)
        if ov > 0:
            out.append((name, ov))
            covered += ov
        i += 1
    if g1 - g0 > covered:
        out.append(("outside any span", g1 - g0 - covered))
    return out
