"""The card's bit-exact references, checked on the CPU.

`tests/torch_judges.py` `p3_serial` is P3's serial reference: from the
kernel's own samples and bins it forms each term in float32 and sums each
bin in float64 in ascending sample order, rounded once. chip_smoke.py and
tests/test_torch_gpu.py hold P3 (csrc/sift_sample.cu) bit-equal to it.
Here it is held to a plain Python float64 loop bit for bit (empty bins,
a slot whose samples all fall in one bin, the window's zero ring, a NaN
sample), and on a detection of tests/test_torch_sift.py's scene to the
plain version's histogram, within 1e-6 of each bin's sum.
"""

import math

import numpy as np
import pytest
import torch

from rpe_tpu_torch.config import SiftConfig
from rpe_tpu_torch.ops import sift
from rpe_tpu_torch.utils.synthetic import make_sequence
from torch_judges import p3_serial

NS = 24 * 24


def _python_hist(vx, vy, bins):
    """Each slot's 36 bins by a Python loop: float32 terms (numpy scalars
    round each step), float64 sums in sample order."""
    w = sift._grid_weights()[0].reshape(-1).numpy()
    out = np.zeros((vx.shape[0], 36), np.float32)
    for n in range(vx.shape[0]):
        acc = [0.0] * 36
        for s in range(NS):
            x, y = np.float32(vx[n, s]), np.float32(vy[n, s])
            t = np.float32(np.sqrt(np.float32(x * x) + np.float32(y * y)))
            acc[int(bins[n, s])] += float(np.float32(t * w[s]))
        out[n] = np.array(acc, np.float64).astype(np.float32)
    return out


def _samples(seed):
    """Six slots of samples and bins: random bins; bins drawn from five
    values only (31 empty); every sample in bin 7; one sample in each of
    the 36 bins and the rest in bin 35; huge and tiny samples (terms over
    many binades); a NaN sample in bin 3."""
    g = np.random.default_rng(seed)
    n = 6
    vx = g.normal(size=(n, NS)).astype(np.float32)
    vy = g.normal(size=(n, NS)).astype(np.float32)
    bins = g.integers(0, 36, (n, NS))
    bins[1] = g.choice([0, 9, 17, 32, 35], NS)
    bins[2] = 7
    bins[3] = 35
    bins[3, :36] = np.arange(36)
    vx[4] *= np.float32(10.0) ** g.integers(-15, 15, NS).astype(np.float32)
    vx[5, 100], bins[5, 100] = np.nan, 3
    return vx, vy, bins.astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_p3_serial_is_the_python_loop(seed):
    vx, vy, bins = _samples(seed)
    got = p3_serial(torch.from_numpy(vx).reshape(-1, 24, 24),
                    torch.from_numpy(vy).reshape(-1, 24, 24),
                    torch.from_numpy(bins)).numpy()
    want = _python_hist(vx, vy, bins)
    assert got.shape == (6, 36)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[1] == 0).sum() >= 31 and (got[2] > 0).sum() == 1
    assert math.isnan(got[5, 3]) and np.isfinite(np.delete(got[5], 3)).all()


def test_p3_serial_keeps_the_batch_shape():
    vx, vy, bins = _samples(2)
    t = [torch.from_numpy(a) for a in (vx, vy, bins)]
    flat = p3_serial(t[0].reshape(6, 24, 24), t[1].reshape(6, 24, 24), t[2])
    lead = p3_serial(t[0].reshape(2, 3, 24, 24), t[1].reshape(2, 3, 24, 24),
                     t[2].reshape(2, 3, NS))
    assert lead.shape == (2, 3, 36)
    assert torch.equal(lead.reshape(6, 36).view(torch.int32),
                       flat.view(torch.int32))


def test_p3_serial_agrees_with_the_plain_histogram_on_a_scene():
    """tests/test_torch_sift.py's scene (3 frames of 120x400, 512 slots):
    every octave's orientation histogram of the plain version against
    p3_serial on the plain version's own samples and bins, within 1e-6 of
    each bin's sum (the terms are >= 0)."""
    frames, _, _ = make_sequence(3, 120, 400, seed=4)
    calls = []
    hist_fn = sift.orientation_hist

    def record(*a):
        calls.append(a)
        return hist_fn(*a)

    sift.orientation_hist = record
    try:
        sift.sift_detect_and_describe(torch.from_numpy(frames),
                                      SiftConfig(max_kpts=512))
    finally:
        sift.orientation_hist = hist_fn
    assert len(calls) == 3
    slots = 0
    for a in calls:
        hist, vx, vy, bins = sift.orientation_hist_plain(*a, detail=True)
        ref = p3_serial(vx, vy, bins)
        assert ref.shape == hist.shape
        scale = ref.double()
        assert bool(((hist.double() - scale).abs()
                     <= 1e-6 * scale + 1e-30).all())
        slots += int((ref.sum(-1) > 0).sum())
    assert slots > 300
