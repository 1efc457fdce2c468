"""``correct`` comes out false for the control and for each fault a cell
can have, planted under the timed path; the run is otherwise whole (the
harness's look for a card is skipped: the port's plain torch versions
run on the host at a tiny size)."""

from __future__ import annotations

import numpy as np
import pytest
from conftest import run_cell

CELLS = ["cd16-library-decode", "hires24-library-decode", "cd16-library-encode",
         "cd16-library-decode-4card"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(checkout, workload):
    r = run_cell(checkout, workload)
    assert r["correct"], r
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(checkout, workload):
    """The reference in the program's place with each sample's low byte
    dropped (the precision below the configuration's)."""
    r = run_cell(checkout, workload, seconds=0.2, answer="control")
    assert not r["correct"]
    assert all(c["value"] > c["limit"] for c in r["checks"].values())


def _decode_fault(monkeypatch, fault):
    from alacnet_tpu_torch import batch

    orig = batch.decode_blob

    def broken(*a, **k):
        out, n, status = orig(*a, **k)
        return fault(np.array(out)), n, status

    monkeypatch.setattr(batch, "decode_blob", broken)


def _altered(out):
    out[len(out) // 2, 1, 0] ^= 1
    return out


def _half_left_out(out):
    out[1::2] = 0
    return out


DECODE_FAULTS = {
    "a sample altered where it is produced": _altered,
    "half of the batch left out": _half_left_out,
    "the output left as it was allocated": np.zeros_like,
}


@pytest.mark.parametrize("fault", sorted(DECODE_FAULTS))
@pytest.mark.parametrize("workload", ["cd16-library-decode", "hires24-library-decode"])
def test_decode_fault_is_not_correct(checkout, monkeypatch, workload, fault):
    _decode_fault(monkeypatch, DECODE_FAULTS[fault])
    r = run_cell(checkout, workload)
    assert not r["correct"]
    assert r["checks"]["wrong_samples"]["value"] > 0


def test_exchange_between_cards_left_out(checkout, monkeypatch):
    """Over the mesh, only the first shard's lanes come back."""
    from alacnet_tpu_torch.parallel import mesh

    orig = mesh.Sharded.fetch

    def first_shard_only(self, limit=None):
        wait = orig(self, limit)
        keep = self.parts[0].shape[self.axis]

        def broken():
            out = np.array(wait())
            out[keep:] = 0
            return out

        return broken

    monkeypatch.setattr(mesh.Sharded, "fetch", first_shard_only)
    r = run_cell(checkout, "cd16-library-decode-4card")
    assert not r["correct"]
    assert r["checks"]["wrong_samples"]["value"] > 0


def _encode_fault(monkeypatch, fault):
    from alacnet_tpu_torch.codec import encoder_device

    orig = encoder_device.encode_frames_device

    def broken(*a, **k):
        return fault(list(orig(*a, **k)))

    monkeypatch.setattr(encoder_device, "encode_frames_device", broken)


def _byte_altered(frames):
    i = len(frames) // 2
    b = bytearray(frames[i])
    b[len(b) // 2] ^= 0x10
    frames[i] = bytes(b)
    return frames


def _half_frames_left_out(frames):
    half = len(frames) // 2
    return frames[:half] + frames[: len(frames) - half]


@pytest.mark.parametrize("fault", [_byte_altered, _half_frames_left_out])
def test_encode_fault_is_not_correct(checkout, monkeypatch, fault):
    _encode_fault(monkeypatch, fault)
    r = run_cell(checkout, "cd16-library-encode")
    assert not r["correct"]
    assert r["checks"]["wrong_bytes"]["value"] > 0
