"""Frame-parallel adaptive FIR/LPC reconstruction in plain torch.

The counterpart of ``alacnet_tpu/ops/lpc.py``
(PredictorDecompressFirAdapt, AlacFile.cs:256-336), with the same
**base-aligned** layout, so that per-lane variable order never turns into
dynamic indexing inside the loop:

  * window D (B, 32):  D[t] = out[i - 1 - order + t], i.e. D[0] is the
    FIR base sample and D[order] the most recent output.  Each step
    shifts D left by one and writes the new output at slot ``order``.
  * coefficients rc (B, 32): rc[t] = coef[order - t] (reversed), so the
    FIR sum is  sum_t (D[t] - D[0]) * rc[t]  over t = 1..31 (rc zero past
    order), and the adaptive walk  pn = order-1 .. 0  becomes the walk
    t = 0..30 touching rc[t+1] and D[t+1].

Order 0 (passthrough) and order 31 (pure integration) are per-lane
modes; the warm-up phase is the integration mode applied while
i <= order.  This is the plain version of the ``rice_lpc`` CUDA kernel's
LPC half.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bitops import I32, sign_i32, signext

MAX_ORDER = 31  # 5-bit field (AlacFile.cs:464)


class LpcParams(NamedTuple):
    """Per-lane predictor parameters."""

    order: torch.Tensor  # (B,) int32, 0..31
    quant: torch.Tensor  # (B,) int32, 0..15
    rc: torch.Tensor  # (B, 32) int32 — base-aligned reversed coefs (slot 0 unused)
    rss: torch.Tensor  # (B,) int32 readsamplesize


def reverse_coefs(coefs: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Host helper: raw coef table (B, 31) + order (B,) -> rc (B, 32).

    rc[b, t] = coefs[b, order[b] - t] for t in 1..order[b], else 0.
    """
    B = coefs.shape[0]
    rc = np.zeros((B, MAX_ORDER + 1), dtype=np.int32)
    for b in range(B):
        o = int(order[b])
        if 0 < o < MAX_ORDER:
            rc[b, 1 : o + 1] = coefs[b, :o][::-1]
    return rc


def lpc_decode(errors, n, params: LpcParams, num_samples: int):
    """Reconstruct samples from residuals.

    errors: (B, S) int32 Rice output;  n: (B,) valid counts.  Returns
    (B, S) int32 outputs, zero at i >= n.  The adaptive walk runs to the
    deepest FIR order present (slots past a lane's order carry zero
    coefficients and are never walked), and the loop stops at the
    largest ``n``: both bounds only skip steps that change nothing.
    """
    order = params.order.to(I32)
    quant = params.quant.to(I32)
    rss = params.rss.to(I32)
    B = errors.shape[0]
    dev = errors.device
    S = num_samples
    if B == 0 or S == 0:
        return torch.zeros((B, S), dtype=I32, device=dev)

    is_pass = order == 0
    is_int31 = order == MAX_ORDER
    slots = torch.arange(MAX_ORDER + 1, dtype=I32, device=dev)
    append_hot = slots[None, :] == order[:, None]
    qshift = (quant - 1) & 31
    fir_orders = order[~is_int31]
    walk = int(fir_orders.max()) if fir_orders.numel() else 0
    steps = min(S, max(1, int(n.max())))

    outs = torch.zeros((B, S), dtype=I32, device=dev)
    # i = 0: the first sample always copies (AlacFile.cs:259-260).
    err0 = errors[:, 0]
    outs[:, 0] = err0
    prev = err0
    D = torch.where(append_hot, err0[:, None], 0).to(I32)
    rc = params.rc.to(I32).clone()
    for i in range(1, steps):
        err = errors[:, i]
        out_int = signext(prev + err, rss)
        base = D[:, 0]
        fir = ((D[:, 1:] - base[:, None]) * rc[:, 1:]).sum(dim=1, dtype=I32)
        outval = ((1 << qshift) + fir) >> quant
        out_fir = signext(outval + base + err, rss)

        use_int = is_int31 | (i <= order)
        out = torch.where(is_pass, err, torch.where(use_int, out_int, out_fir))

        do_adapt = ~(is_pass | is_int31 | use_int)
        pos_b = do_adapt & (err > 0)
        neg_b = do_adapt & (err < 0)
        ev = err
        vals = base[:, None] - D[:, 1 : walk + 1]
        sgns = sign_i32(vals)
        for t in range(walk):
            act_p = pos_b & (t < order) & (ev > 0)
            act_n = neg_b & (t < order) & (ev < 0)
            act = act_p | act_n
            # A lane that stops acting never acts again (its ev keeps
            # its sign and t < order only turns false), so the walk can
            # end once no lane acts.
            if not bool(act.any()):
                break
            val, sgn = vals[:, t], sgns[:, t]
            sign_eff = torch.where(act_p, sgn, torch.where(act_n, -sgn, 0))
            rc[:, t + 1] -= sign_eff
            ev = torch.where(act, ev - ((val * sign_eff) >> quant) * (t + 1), ev)

        D = torch.where(append_hot, out[:, None], torch.roll(D, -1, dims=1))
        live = i < n
        out = torch.where(live, out, 0)
        outs[:, i] = out
        prev = torch.where(live, out, prev)
    return outs
