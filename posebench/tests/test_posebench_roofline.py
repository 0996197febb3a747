"""The roofline's per-kernel counts against chip_smoke.py's figures at its
own shapes (one chunk of 8 pairs of 1241x376 frames)."""

import importlib.util

import pytest
import torch

import roofline
from helpers import ROOT


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_figures",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_peaks(smoke):
    assert roofline.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert roofline.FP32_OPS_PER_S == smoke.FP32_OPS_PER_S
    assert roofline.TF32X3_OPS_PER_S == smoke.TF32X3_TC_OPS_PER_S
    assert roofline.INT8_OPS_PER_S == smoke.INT8_TC_OPS_PER_S


def test_p1_p3_p4_constants(smoke):
    assert (roofline.P1_OPS, roofline.P1_BYTES) == (smoke.P1_OPS,
                                                    smoke.P1_BYTES)
    assert (roofline.P3_OPS_PER_SAMPLE, roofline.P4_OPS_PER_SAMPLE,
            roofline.P4_OPS_PER_SLOT) == (smoke.P3_OPS_PER_SAMPLE,
                                          smoke.P4_OPS_PER_SAMPLE,
                                          smoke.P4_OPS_PER_SLOT)


def test_k4_p1_at_chip_smoke_shapes():
    # chip_smoke: bsz = 8 pairs x 256 hypotheses, k4_ops = bsz * 97 * 835 +
    # n_roots * (10 * 835 + 11000), bytes bsz * 800 + bsz * 10 * 14
    bsz, n_roots = 8 * 256, 7844
    c = roofline.ransac_counts(8, 256, n_roots)
    assert c["K4"][:2] == (bsz * 800 + bsz * 10 * 14,
                           bsz * 97 * 835 + n_roots * (10 * 835 + 11000))
    assert c["P1"][:2] == (bsz * (80 + (36 + 200) * 4), bsz * 7761)


def test_k3_at_chip_smoke_shapes():
    # chip_smoke: (nv1 + nv2) * 256 + npair * (n1 + n2) + 4 * npair *
    # (2 * n1 + n2) bytes and 2 * valid_cells * 256 int8 operations
    g = torch.Generator().manual_seed(0)
    valid = torch.rand((9, 4096), generator=g) < 0.95
    dets = {"valid": valid, "bits": torch.zeros((9, 4096, 256),
                                                dtype=torch.uint8)}
    c = roofline.match_counts(dets, "bits", 1, roofline.INT8_OPS_PER_S,
                              "K3")["K3"]
    v1, v2 = valid[:-1], valid[1:]
    nv1, nv2 = int(v1.sum()), int(v2.sum())
    cells = float((v1.sum(-1).double() * v2.sum(-1).double()).sum())
    want_b = (nv1 + nv2) * 256 + 8 * (4096 + 4096) + 4 * 8 * (2 * 4096 + 4096)
    assert c[0] == pytest.approx(want_b)
    assert c[1] == pytest.approx(2.0 * cells * 256)


def test_k1_per_pixel():
    # chip_smoke: 3 * 4 bytes and 180 operations a pixel, over the pixels
    # of the pyramid's levels here (not the padded atlas)
    from reference import orb

    dets = {"valid": torch.zeros((9, 4096), dtype=torch.bool),
            "xy": torch.zeros((9, 4096, 2)), "level": torch.zeros(
                (9, 4096), dtype=torch.int32), "angle": torch.zeros(
                (9, 4096))}
    c = roofline.orb_counts(dets, 376, 1241, {"nlevels": 12,
                                              "scale_factor": 1.1})
    px = 9 * sum(h * w for h, w in orb.level_shapes(376, 1241, 12, 1.1))
    assert c["K1"][:2] == (12.0 * px, 180.0 * px)
    assert c["K2"][1] == 0.0


def test_k2_counts_union_and_live():
    from reference import orb

    xy = torch.tensor([[[100.0, 100.0], [101.0, 100.0], [300.0, 200.0]]])
    dets = {"valid": torch.tensor([[True, True, False]]), "xy": xy,
            "level": torch.zeros((1, 3), dtype=torch.int32),
            "angle": torch.zeros((1, 3))}
    c = roofline.orb_counts(dets, 376, 1241, {"nlevels": 1,
                                              "scale_factor": 1.1})
    n_ic = int(orb.disk().sum())
    disk = torch.as_tensor(orb.disk())
    union = int((torch.nn.functional.pad(disk, (0, 1)) |
                 torch.nn.functional.pad(disk, (1, 0))).sum())
    pat = orb.pattern().reshape(512, 2)
    blur = len({(int(x) + dx, int(y)) for x, y in pat for dx in (0, 1)})
    assert c["K2"][0] == 4.0 * (union + blur) + 256 * 16 + 2 * (256 + 8)
    assert c["K2"][1] == 2 * (4.0 * n_ic + 256 * 12)


def test_p2_counts():
    a = torch.zeros((5, 7, 9))
    b = torch.zeros((9, 3)).expand(5, 9, 3)
    x = torch.zeros((5, 4))
    launch = roofline.p2_terms([(a, b), (x, None)],
                               [torch.zeros((5, 7, 3)), torch.zeros(5)])
    nbytes, flops = roofline.p2_counts(launch)
    assert nbytes == 4.0 * (5 * 7 * 9 + 9 * 3 + 5 * 4 + 5 * 7 * 3 + 5)
    assert flops == 2.0 * 5 * 7 * 3 * 9 + 5 * 4
