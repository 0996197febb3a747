"""csrc/extract_brief.cu's host side on the CPU: what the kernel
hard-codes (the IC mask's extents in csrc/slot_warp.cuh, shared with K9 and
K10 in csrc/extract_patches.cu; the shared row stride), the table layouts
the wrapper hands it (checked by running the kernel's per-lane indexing of
its shared patches in numpy against the plain versions), and the
launchers' argument types set once per library after their layout
checks.

The kernels themselves run only on the card (tests/test_torch_gpu.py)."""

import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rpe_tpu_torch.ops import extract as textract
from rpe_tpu_torch.ops.orb import PATCH, PATCH_R, _ic_angle_masks, \
    angle_bins, brief_pattern, ic_moments, steered_brief, \
    steered_brief_t_binned

CSRC = Path(textract.__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "extract_brief.cu"
HEADER = CSRC / "slot_warp.cuh"


def _source_umax():
    m = re.search(r"kUmax\[PATCH_R \+ 1\] = \{([^}]*)\}",
                  HEADER.read_text())
    assert m, "kUmax table not found in slot_warp.cuh"
    return [int(x) for x in m.group(1).replace("\n", " ").split(",")]


def _source_sample_r():
    m = re.search(r"#define SAMPLE_R (\d+)", SOURCE.read_text())
    assert m, "SAMPLE_R not found in extract_brief.cu"
    return int(m.group(1))


def _source_wide_r():
    m = re.search(r"#define WIDE_R (\w+)", SOURCE.read_text())
    assert m, "WIDE_R not found in extract_brief.cu"
    return PATCH_R if m.group(1) == "PATCH_R" else int(m.group(1))


def test_kernel_umax_table_equals_ic_masks():
    """The extents the kernel hard-codes give `_ic_angle_masks()`'s mask:
    row v covers |u| <= umax[|v|]; the pattern lies within its sample
    radius."""
    umax = _source_umax()
    assert umax == textract.ic_umax().tolist()
    assert (brief_pattern() ** 2).sum(-1).max() <= _source_sample_r() ** 2
    v, u = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
    mask = np.abs(u) <= np.array(umax)[np.abs(v)]
    np.testing.assert_array_equal(mask, _ic_angle_masks()[0] > 0)


@pytest.mark.parametrize("source", ["extract_brief.cu", "extract_patches.cu"])
def test_sources_share_one_umax_table_and_fold(source):
    """K2, K12, K9 and K10 take the IC mask's extents and the moment fold
    from slot_warp.cuh, and neither source keeps a table of its own."""
    text = (CSRC / source).read_text()
    assert '#include "slot_warp.cuh"' in text
    assert "kUmax[PATCH_R + 1] =" not in text
    assert "ic_fold(raw, lane, m10, m01);" in text


def _variants():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import extract_variants
    return extract_variants.VARIANTS


@pytest.mark.parametrize("name", sorted(_variants()))
def test_variant_edits_find_their_text(name):
    """Each design-step variant of scripts/extract_variants.py edits text
    that occurs exactly once in its source, so it builds what it names."""
    key, _, edits = _variants()[name]
    text = (CSRC / f"{key}.cu").read_text()
    for old, _ in edits:
        assert text.count(old) == 1, old


class _Launch:
    """A ctypes function stand-in that counts assignments of argtypes."""

    def __init__(self):
        self.__dict__["sets"] = 0

    def __setattr__(self, key, value):
        if key == "argtypes":
            self.__dict__["sets"] += 1
        self.__dict__[key] = value


class _Lib:
    def __init__(self, layout):
        self.layout = layout
        self.extract_brief_launch = _Launch()
        self.extract_patches_launch = _Launch()

    def extract_brief_layout(self, buf):
        for i, x in enumerate(self.layout):
            buf[i] = x

    def extract_patches_layout(self, buf):
        for i, x in enumerate(self.layout[:PATCH_R + 1]):
            buf[i] = x


def _layout():
    return _source_umax() + [_source_sample_r(), _source_wide_r()]


def test_launchers_set_argtypes_once_per_library():
    libs = [_Lib(_layout()) for _ in range(2)]
    for lib in libs:
        for _ in range(3):
            assert textract._brief_launcher(lib) is lib.extract_brief_launch
            assert textract._patch_launcher(lib) is \
                lib.extract_patches_launch
        for fn, n_args in ((lib.extract_brief_launch, 18),
                           (lib.extract_patches_launch, 16)):
            assert fn.sets == 1
            assert fn.restype is ctypes.c_int
            assert len(fn.argtypes) == n_args


@pytest.mark.parametrize("entry,delta,match", [
    (PATCH_R, 1, "umax"), (PATCH_R + 1, -1, "radius"),
    (PATCH_R + 2, -1, "patch rim")],
    ids=["umax", "sample_radius", "wide_radius"])
def test_brief_launcher_refuses_another_layout(entry, delta, match):
    layout = _layout()
    layout[entry] += delta
    lib = _Lib(layout)
    with pytest.raises(RuntimeError, match=match):
        textract._brief_launcher(lib)
    assert lib.extract_brief_launch.sets == 0


@pytest.mark.parametrize("v", [0, PATCH_R])
def test_patch_launcher_refuses_another_umax(v):
    """K9's and K10's extents are held to `ic_umax()` as K2's are."""
    layout = _layout()
    layout[v] -= 1
    lib = _Lib(layout)
    with pytest.raises(RuntimeError, match="extract_patches.cu umax"):
        textract._patch_launcher(lib)
    assert lib.extract_patches_launch.sets == 0


# ---- the kernel's per-lane indexing, in numpy ------------------------------

def _shared(patches, r=None):
    """(K, 31, 31) blurred patches as the kernel copies them: row-major,
    only rows and columns within its sample radius `r` (SAMPLE_R unless
    given) of the centre (the rest junk)."""
    r = _source_sample_r() if r is None else r
    out = np.full(patches.shape, np.nan, np.float32)
    lo, hi = PATCH_R - r, PATCH_R + r + 1
    out[:, lo:hi, lo:hi] = patches[:, lo:hi, lo:hi]
    return out.reshape(patches.shape[0], -1)


def _lane_moments(raw):
    """m10, m01 as the kernel sums them: lane c folds column c's rows in
    order with u, v weights where |u| <= umax[|v|], then a shuffle
    butterfly over 32 lanes."""
    umax = np.array(_source_umax())
    k = raw.shape[0]
    m10 = np.zeros((k, 32), np.float32)
    m01 = np.zeros((k, 32), np.float32)
    for lane in range(PATCH):
        u = lane - PATCH_R
        for r in range(PATCH):
            v = r - PATCH_R
            x = raw[:, r, lane] if abs(u) <= umax[abs(v)] \
                else np.zeros(k, np.float32)
            m10[:, lane] = m10[:, lane] + x * np.float32(u)
            m01[:, lane] = m01[:, lane] + x * np.float32(v)
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        m10 = m10 + m10[:, idx ^ off]
        m01 = m01 + m01[:, idx ^ off]
    assert (m10 == m10[:, :1]).all() and (m01 == m01[:, :1]).all()
    return m10[:, 0], m01[:, 0]


def _lane_bits(blur_s, ca, sa, bins, kind=None, r=None, quant=False):
    """(K, 256) bits as the kernel's lanes sample its shared blurred
    patches with the wrapper's tables of pattern `kind`: K2 at (ca, sa)
    when bins is None (clamped to radius `r`, SAMPLE_R unless given), else
    K12 at those bins; each value rounded half-to-even first with `quant`
    (rintf); a lane's 8 bytes are pairs lane * 8 + k."""
    pat, pairs, _ = textract._brief_tables_np(kind)
    rows = np.arange(blur_s.shape[0])
    out = np.zeros((blur_s.shape[0], 256), np.uint8)
    for lane in range(32):
        for k in range(8):
            if bins is None:
                px0, py0, px1, py1 = pat[k * 32 + lane]
                i0, i1 = (_sample_index(px, py, ca, sa, r)
                          for px, py in ((px0, py0), (px1, py1)))
            else:
                q = pairs[bins, k // 4, lane, k % 4]
                i0, i1 = q & 0xFFFF, q >> 16
            v0, v1 = blur_s[rows, i0], blur_s[rows, i1]
            assert not (np.isnan(v0) | np.isnan(v1)).any()
            if quant:
                v0, v1 = np.rint(v0), np.rint(v1)
            out[:, lane * 8 + k] = v0 < v1
    return out


def _sample_index(px, py, ca, sa, r=None):
    """The kernel's `sample_index`: rounded half to even (NaN to 0, as the
    card's float-to-int conversion), clamped to |ix|, |iy| <= r (SAMPLE_R
    unless given)."""
    r = _source_sample_r() if r is None else r
    rx = np.float32(px) * ca - np.float32(py) * sa
    ry = np.float32(px) * sa + np.float32(py) * ca
    ix, iy = (np.clip(np.nan_to_num(np.rint(a), nan=0.0), -r, r)
              .astype(np.int64) for a in (rx, ry))
    return (iy + PATCH_R) * PATCH + ix + PATCH_R


def _lane_bins(m10, m01, lanes=False):
    """The kernel's shuffle argmax: largest m10 cos_b + m01 sin_b over 32
    lanes (lanes 30, 31 at -inf and bin 0), lowest b among ties, lane 0's
    bin broadcast. With `lanes`, every lane's bin before the broadcast."""
    _, _, cs = textract._brief_tables_np()
    d = np.full((m10.shape[0], 32), -np.inf, np.float32)
    with np.errstate(invalid="ignore"):
        d[:, :30] = m10[:, None] * cs[None, :30] + m01[:, None] * cs[None, 30:]
    b = np.broadcast_to(np.where(np.arange(32) < 30, np.arange(32), 0),
                        d.shape).copy()
    for off in (16, 8, 4, 2, 1):
        od, ob = d[:, np.arange(32) ^ off], b[:, np.arange(32) ^ off]
        take = (od > d) | ((od == d) & (ob < b))
        d, b = np.where(take, od, d), np.where(take, ob, b)
    return b if lanes else b[:, 0]


@pytest.fixture(scope="module")
def patches():
    g = np.random.default_rng(8)
    raw = g.uniform(0, 255, size=(64, PATCH, PATCH)).astype(np.float32)
    raw[0] = 77.0                         # constant: zero moments, angle 0
    blur = g.uniform(0, 255, size=(64, PATCH, PATCH)).astype(np.float32)
    return raw, blur


def test_lane_moments_match_plain(patches):
    raw, _ = patches
    m10, m01 = _lane_moments(raw)
    p10, p01 = (t.numpy() for t in ic_moments(torch.from_numpy(raw)))
    np.testing.assert_allclose(m10, p10, rtol=1e-4, atol=2.0)
    np.testing.assert_allclose(m01, p01, rtol=1e-4, atol=2.0)
    assert m10[0] == 0.0 and m01[0] == 0.0


def test_lane_layout_gives_plain_bits(patches):
    """The wrapper's pattern and pair tables, indexed as the kernel's lanes
    index the blurred pixels it copies, give the plain versions' bits
    exactly: K2 at the plain version's own (cos, sin), K12 at the bins of
    the same moments; no sample reaches a pixel it does not copy (NaN
    here)."""
    raw, blur = patches
    m10, m01 = _lane_moments(raw)
    blur_s = _shared(blur)
    ang = torch.atan2(torch.from_numpy(m01), torch.from_numpy(m10))
    ca, sa = (t.numpy() for t in (torch.cos(ang), torch.sin(ang)))
    k2 = _lane_bits(blur_s, ca, sa, None)
    np.testing.assert_array_equal(
        k2, steered_brief(torch.from_numpy(blur), ang).numpy())
    bins = _lane_bins(m10, m01)
    t10, t01 = torch.from_numpy(m10), torch.from_numpy(m01)
    np.testing.assert_array_equal(bins, angle_bins(t10, t01).numpy())
    assert bins[0] == 0
    k12 = _lane_bits(blur_s, None, None, bins)
    blur_t = torch.from_numpy(blur).transpose(-1, -2).contiguous()
    np.testing.assert_array_equal(
        k12, steered_brief_t_binned(blur_t, t10, t01).numpy())


def test_lane_model_keeps_nonfinite_moments_inside_the_tables():
    """Non-finite moments (a non-finite atlas): every lane's K12 bin is a
    row of the pair table and the slot takes bin 0 when the moments are
    NaN; K2's clamped samples stay among the pixels the kernel copies
    (NaN there)."""
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    m10 = np.array([nan, inf, -inf, inf, 0.0], np.float32)
    m01 = np.array([nan, inf, inf, nan, nan], np.float32)
    lane_bins = _lane_bins(m10, m01, lanes=True)
    assert ((0 <= lane_bins) & (lane_bins < 30)).all()
    bins = _lane_bins(m10, m01)
    assert bins[0] == 0 and bins[3] == 0 and bins[4] == 0
    g = np.random.default_rng(3)
    blur_s = _shared(g.uniform(0, 255, (5, PATCH, PATCH)).astype(np.float32))
    with np.errstate(invalid="ignore"):
        r = np.sqrt(m10 * m10 + m01 * m01)
        ca = np.where(r > 0, m10 / r, np.float32(1.0)).astype(np.float32)
        sa = np.where(r > 0, m01 / r, np.float32(0.0)).astype(np.float32)
        for big in (np.float32(1e30), np.float32(-1e30)):
            _lane_bits(blur_s, np.full(5, big, np.float32),
                       np.full(5, -big, np.float32), None)
        _lane_bits(blur_s, ca, sa, None)
    _lane_bits(blur_s, None, None, bins)


@pytest.mark.parametrize("kind,quant", [("cv2", True), ("cv2", False),
                                        ("gauss", True)])
def test_lane_layout_gives_plain_bits_in_each_mode(patches, kind, quant):
    """The mode the wrapper picks (`brief_mode`: the wide radius for a
    pattern past SAMPLE_R, rounded samples with `quant`), modelled as the
    kernel's lanes run it, gives the plain versions' bits exactly: K2 and
    K12 on the wrapper's tables of the pattern, with the copied region of
    that mode (NaN outside)."""
    raw, blur = patches
    g = np.random.default_rng(5)
    blur = (g.integers(0, 40, blur.shape) * 0.5).astype(np.float32)
    wide = textract.pattern_reach2(kind) > _source_sample_r() ** 2
    assert wide == (kind == "cv2")

    class _L:
        def extract_brief_layout(self, buf):
            for i, x in enumerate(_layout()):
                buf[i] = x

    mode = textract.brief_mode(_L(), False, quant, kind)
    assert mode == ((textract.MODE_WIDE if wide else 0)
                    | (textract.MODE_QUANT if quant else 0))
    assert textract.brief_mode(_L(), True, quant, kind) == \
        mode | textract.MODE_BINNED
    r = _source_wide_r() if wide else _source_sample_r()
    blur_s = _shared(blur, r)
    m10, m01 = _lane_moments(raw)
    ang = torch.atan2(torch.from_numpy(m01), torch.from_numpy(m10))
    ca, sa = (t.numpy() for t in (torch.cos(ang), torch.sin(ang)))
    k2 = _lane_bits(blur_s, ca, sa, None, kind, r, quant)
    np.testing.assert_array_equal(k2, steered_brief(
        torch.from_numpy(blur), ang, quant=quant, kind=kind).numpy())
    t10, t01 = torch.from_numpy(m10), torch.from_numpy(m01)
    k12 = _lane_bits(blur_s, None, None, _lane_bins(m10, m01), kind, r,
                     quant)
    blur_t = torch.from_numpy(blur).transpose(-1, -2).contiguous()
    np.testing.assert_array_equal(k12, steered_brief_t_binned(
        blur_t, t10, t01, quant=quant, kind=kind).numpy())
    if wide:
        # the narrow copy would leave samples of this pattern unread
        with pytest.raises(AssertionError):
            _lane_bits(_shared(blur), ca, sa, None, kind, r, quant)
