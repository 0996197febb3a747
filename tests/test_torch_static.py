"""rpe_tpu_torch against rpe_tpu: threefry keys, configuration, the static
tables the port regenerates, and the port's import boundary."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpe_tpu.config as jcfg
from rpe_tpu.geometry import five_point as jfp
from rpe_tpu.ops import atlas as jatlas
from rpe_tpu.ops import orb as jorb
from rpe_tpu.ops import pyramid as jpyr
from rpe_tpu_torch import convert, rng
from rpe_tpu_torch import config as tcfg
from rpe_tpu_torch.geometry import five_point as tfp
from rpe_tpu_torch.ops import atlas as tatlas
from rpe_tpu_torch.ops import orb as torb
from rpe_tpu_torch.ops import pyramid as tpyr

ROOT = Path(__file__).resolve().parents[1]


# ---- threefry --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1, -3])
def test_prngkey_split_fold_in_bit_equal(seed):
    k = jax.random.PRNGKey(seed)
    kt = rng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(k).astype(np.int64), kt.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(k)).astype(np.int64),
        rng.split(kt).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(k, 5)).astype(np.int64),
        rng.split(kt, 5).numpy())
    for d in (7, 11, 0):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(k, d)).astype(np.int64),
            rng.fold_in(kt, d).numpy())


@pytest.mark.parametrize("shape", [(256, 5), (128, 5), (64, 4), (64, 2),
                                   (2048, 8), (8, 16), (3,)])
def test_uniform_bit_equal_at_ransac_shapes(shape):
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(np.arange(4)))
    keys = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 7))(keys))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
    got = rng.uniform(convert.keys_from_numpy(keys), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want, got)
    # the DEGENSAC sub-keys: fold_in(key, 7) then split
    ks = np.asarray(jax.vmap(jax.random.split)(keys))
    np.testing.assert_array_equal(
        ks.astype(np.int64), rng.split(convert.keys_from_numpy(keys)).numpy())


def _threefry_serial(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (Salmon et al., Random123), of one counter
    pair under one key, in Python integers."""
    m = 0xFFFFFFFF
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (x1 + ks[0]) & m, (x2 + ks[1]) & m
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            a = (a + b) & m
            b = (((b << r) & m) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & m
        b = (b + ks[(i + 2) % 3] + i + 1) & m
    return a, b


def test_threefry_plain_is_the_serial_hash():
    """`threefry2x32_plain` (P8's plain version) word for word against a
    serial hash in Python integers, on seeded keys and counters broadcast
    as `split` and `fold_in` broadcast them; the serial hash gives
    Random123's known answers."""
    assert _threefry_serial(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    assert _threefry_serial(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF,
                            0xFFFFFFFF) == (0x1CB996FC, 0xBB002BE7)
    assert _threefry_serial(0x13198A2E, 0x03707344, 0x243F6A88,
                            0x85A308D3) == (0xC4923A9C, 0x483DF7A0)
    g = np.random.default_rng(23)
    keys = torch.from_numpy(g.integers(0, 2 ** 32, (6, 2)))
    ctr = torch.from_numpy(g.integers(0, 2 ** 32, (2, 5)))
    got = rng.threefry2x32_plain(keys[:, 0, None], keys[:, 1, None],
                                 ctr[0], ctr[1])
    want = [[_threefry_serial(*k, *c) for c in ctr.T.tolist()]
            for k in keys.tolist()]
    assert got[0].shape == (6, 5)
    assert torch.stack(got, -1).tolist() == [[list(w) for w in row]
                                             for row in want]


# ---- configuration -----------------------------------------------------------

@pytest.mark.parametrize("name", jcfg.PROFILE_NAMES)
def test_config_profiles_cross_over(name):
    jc = jcfg.profile_config(name)
    tc = tcfg.profile_config(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert convert.config_from_dict(dataclasses.asdict(jc)) == tc


def test_detections_from_numpy_dtypes():
    det = {"xy": np.zeros((2, 5, 2), np.float32),
           "angle": np.zeros((2, 5), np.float32),
           "level": np.zeros((2, 5), np.int32),
           "score": np.zeros((2, 5), np.float32),
           "bits": np.ones((2, 5, 256), np.uint8),
           "valid": np.ones((2, 5), bool)}
    t = convert.detections_from_numpy(det)
    assert t["bits"].dtype == torch.uint8 and t["valid"].dtype == torch.bool
    assert t["level"].dtype == torch.int32 and t["xy"].shape == (2, 5, 2)


def test_detections_from_numpy_carries_sift_float_descriptors():
    g = np.random.default_rng(0)
    det = {"xy": g.uniform(size=(2, 5, 2)).astype(np.float32),
           "angle": g.uniform(-3, 3, size=(2, 5)).astype(np.float32),
           "level": np.arange(10, dtype=np.int32).reshape(2, 5),
           "score": np.ones((2, 5), np.float32),
           "desc": g.uniform(size=(2, 5, 128)).astype(np.float32),
           "valid": np.ones((2, 5), bool)}
    t = convert.detections_from_numpy(det)
    assert set(t) == set(det)
    assert t["desc"].dtype == torch.float32 and t["desc"].shape == (2, 5, 128)
    for k in ("desc", "angle", "level"):
        np.testing.assert_array_equal(t[k].numpy(), det[k])
    assert t["level"].dtype == torch.int32


# ---- regenerated static tables -------------------------------------------------

def test_orb_tables_equal():
    np.testing.assert_array_equal(jorb.brief_pattern(kind="gauss"),
                                  torb.brief_pattern())
    for a, b in zip(jorb._ic_angle_masks(), torb._ic_angle_masks()):
        np.testing.assert_array_equal(a, b)
    for args in [(4000, 12, 1.1), (2000, 8, 1.1), (512, 4, 1.1), (256, 4, 1.1)]:
        assert jorb.level_quotas(*args) == torb.level_quotas(*args)


@pytest.mark.parametrize("hw", [(376, 1241), (160, 320), (480, 640)])
@pytest.mark.parametrize("nlevels", [12, 4])
def test_atlas_tables_equal(hw, nlevels):
    h, w = hw
    assert jpyr.level_shapes(h, w, nlevels, 1.1) == \
        tpyr.level_shapes(h, w, nlevels, 1.1)
    assert jatlas.atlas_layout(h, w, nlevels, 1.1) == \
        tatlas.atlas_layout(h, w, nlevels, 1.1)
    rj, cj = jatlas._atlas_resize_mats(h, w, nlevels, 1.1)
    rt, ct = tatlas._atlas_resize_mats(h, w, nlevels, 1.1)
    np.testing.assert_array_equal(rj, rt)
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(a, b)
    offsets, total, wp = tatlas.atlas_layout(h, w, nlevels, 1.1)
    shapes = tuple(tpyr.level_shapes(h, w, nlevels, 1.1))
    np.testing.assert_array_equal(
        jorb._atlas_valid_mask(offsets, total, wp, shapes, 19),
        torb._atlas_valid_mask(offsets, total, wp, shapes, 19))


def test_five_point_tables_equal():
    for a, b in zip(jfp._mul_tables(), tfp._mul_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jfp._deriv_tables(), tfp._deriv_tables())
    np.testing.assert_array_equal(jfp._hidden_var_table(),
                                  tfp._hidden_var_table())
    np.testing.assert_array_equal(jfp._flip_table(), tfp._flip_table())
    assert jfp._M3 == tfp._M3
    # the tan grid: jnp.linspace rounds differently by at most 2 ulp
    t = np.asarray(jnp.linspace(-0.5 * jnp.pi + 1e-3, 0.5 * jnp.pi - 1e-3,
                                jfp.GRID))
    assert np.abs(t - tfp._tan_grid()).max() <= 2.5e-7
    # the kernel's hard-coded index tables agree with the monomial algebra
    gm, flip, exps = tfp._kernel_tables()
    S = jfp._hidden_var_table()
    for g in range(10):
        for c in range(4):
            m = np.nonzero(S[:, g, c])[0]
            assert (gm[g, c] == m[0]) if len(m) else gm[g, c] == -1
    np.testing.assert_array_equal(np.argmax(jfp._flip_table(), axis=1), flip)


def test_gaussian_weights_match_kernel_taps():
    from rpe_tpu.ops.fast_pallas import _gauss7

    np.testing.assert_array_equal(np.float32(_gauss7()),
                                  np.float32(tatlas.gaussian_weights()))


# ---- import boundary ------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "rpe_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    subpackages = {f.relative_to(ROOT / "rpe_tpu_torch").parts[0]
                   for f in files[:-1]}
    assert {"io", "cli", "pipeline", "geometry", "ops", "utils",
            "viz", "tools", "parallel"} <= subpackages
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"rpe_tpu_torch/{m}.py" for m in (
        "ops/lsd", "geometry/vp_refine", "pipeline/orchestrator",
        "viz/visualizer", "cli/run_simulator_data", "cli/run_phone_data",
        "cli/run_vo_database_salah", "cli/run_single_pair",
        "tools/calibrate", "ops/brief_cv2_pattern", "parallel/__init__",
        "parallel/mesh", "parallel/collectives", "parallel/multihost",
        "parallel/sharded_estimator")} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "rpe_tpu", "flax"), (f, mod)
        assert "import jax" not in f.read_text(), f


def _code_strings(path):
    """String constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_port_keeps_its_own_decoder_and_no_path_into_the_reference():
    """rpe_tpu_torch/io/ holds its own loader.cpp (the reference's source
    below the header), and no code string or #include under rpe_tpu_torch/
    names a path inside rpe_tpu/."""
    import re

    mine = (ROOT / "rpe_tpu_torch/io/native/loader.cpp").read_text()
    ref = (ROOT / "rpe_tpu/io/native/loader.cpp").read_text()
    cut = "#include <zlib.h>"
    assert mine[mine.index(cut):] == ref[ref.index(cut):]
    into_ref = re.compile(r"(?<![\w])rpe_tpu[/\\]")
    for f in sorted((ROOT / "rpe_tpu_torch").rglob("*.py")):
        for text in _code_strings(f):
            assert not into_ref.search(text), (f, text)
    for pattern in ("*.cu", "*.cuh", "*.cpp"):
        for f in (ROOT / "rpe_tpu_torch").rglob(pattern):
            for line in f.read_text().splitlines():
                if line.lstrip().startswith("#include"):
                    assert "rpe_tpu" not in line, (f, line)


# names of the reference's `__all__` the port leaves out on purpose: its
# `utils.trace` wrote a TensorBoard trace that nothing called; a caller of
# the port takes its own torch.profiler trace, which records the port's spans
NOT_EXPORTED = {"utils": {"trace"}}


@pytest.mark.parametrize("sub", ["ops", "geometry", "pipeline", "utils",
                                 "parallel"])
def test_subpackages_export_the_reference_names(sub):
    """Each subpackage's `__all__` is the reference's (less NOT_EXPORTED),
    every name bound; the reference's fused matchers name the port's
    kernel-backed ones."""
    import importlib

    ref = importlib.import_module(f"rpe_tpu.{sub}")
    port = importlib.import_module(f"rpe_tpu_torch.{sub}")
    dropped = NOT_EXPORTED.get(sub, set())
    assert dropped <= set(ref.__all__)
    assert port.__all__ == [n for n in ref.__all__ if n not in dropped]
    assert not any(hasattr(port, n) for n in dropped)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    if sub == "ops":
        from rpe_tpu_torch.ops import match

        assert port.cross_check_match_fused is match.match_hamming
        assert port.ratio_match_fused is match.match_ratio


def test_calibration_tool_imports_neither_jax_nor_reference():
    """tools/calibrate.py takes `_so3_exp_np` from the port's vp_refine and
    imports cv2 only inside `main`."""
    path = ROOT / "rpe_tpu_torch" / "tools" / "calibrate.py"
    mods = set(_imports(path))
    assert not {m for m in mods if m.split(".")[0] in (
        "jax", "jaxlib", "rpe_tpu")}, mods
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any(a.name == "cv2" for n in top if isinstance(n, ast.Import)
                   for a in n.names)
    assert any(isinstance(n, ast.ImportFrom) and n.level == 2
               and n.module == "geometry.vp_refine"
               and n.names[0].name == "_so3_exp_np" for n in top)


# ---- device seams: the launchers and caches are right on any card -----------

def test_shared_memory_attribute_is_set_per_device():
    """cudaFuncSetAttribute applies to the current device only, so every
    source that raises a kernel's shared-memory limit reads the device
    (cudaGetDevice) and keeps a bit per device; no once-per-process
    `static bool` guard remains."""
    import re

    csrc = ROOT / "rpe_tpu_torch" / "csrc"
    setters = 0
    for f in sorted(csrc.glob("*.cu*")):
        text = f.read_text()
        assert not re.search(r"static\s+bool", text), f
        n = text.count("cudaFuncSetAttribute(")
        setters += n
        if n:
            assert "cudaGetDevice(&dev)" in text, f
            assert re.search(r"unsigned long long\s*&?\s*\w+", text), f
    assert setters >= 2        # fast_harris.cu's and sm90.cuh's helper
    for f in ("match_hamming.cu", "match_l2.cu"):
        assert (csrc / f).read_text().count("smem_attr_per_device(") == 1, f
    assert "smem_attr_per_device" in (csrc / "sm90.cuh").read_text()


def test_every_launch_goes_through_the_device_guard():
    """Each wrapper launches with `kernels.launch` (which enters the
    tensors' device); no wrapper reads a stream or counts a launch itself."""
    launches = 0
    for f in sorted((ROOT / "rpe_tpu_torch").rglob("*.py")):
        if f.name == "kernels.py":
            continue
        text = f.read_text()
        assert "stream_ptr(" not in text, f
        assert "kernels.check(" not in text, f
        launches += text.count("kernels.launch(")
    # K1, K2/K12, K8-K10, K3, K7/K6-L2, K6-H, K4, K5, P1, P2, P3, P4,
    # P5-P8
    assert launches == 16


def _functions(path):
    return {n.name: n for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.FunctionDef)}


def _calls(fn):
    """Dotted names of the calls in a function's body."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f, parts = node.func, []
            while isinstance(f, ast.Attribute):
                parts.append(f.attr)
                f = f.value
            if isinstance(f, ast.Name):
                out.add(".".join([f.id] + parts[::-1]))
    return out


# the geometry's call sites whose products and sums P2 takes on the card,
# by module: function -> the fixed-order helpers it must call
FIXED_ORDER_SITES = {
    "epipolar.py": {"normal_matrix": {"matmul"},
                    "essential_frame": {"matmul", "matmuls"},
                    "project_to_essential": {"matmuls"}},
    "recover_pose.py": {"decompose_essential": {"matmuls"},
                        "triangulate_depths": {"matmuls"}},
    "homography.py": {"plane_parallax_essentials": {"matmul", "matmuls"},
                      "gric_score": {"row_sum"}},
}


def test_fixed_order_sites_reach_their_kernels():
    """On the card branch `constraint_coeffs` launches P1 and each site
    whose order moved with the batch calls geometry/_products.py, whose
    helpers launch P2; no bare torch.matmul or torch.einsum is left in
    them."""
    geo = ROOT / "rpe_tpu_torch" / "geometry"
    bare = {"torch.matmul", "torch.einsum", "torch.bmm"}
    cc = _functions(geo / "five_point.py")["constraint_coeffs"]
    assert "kernels.launch" in _calls(cc) and not _calls(cc) & bare
    for module, sites in FIXED_ORDER_SITES.items():
        tree = ast.parse((geo / module).read_text())
        helpers = {a.name for n in ast.walk(tree)
                   if isinstance(n, ast.ImportFrom) and n.level == 1
                   and n.module == "_products" for a in n.names}
        fns = _functions(geo / module)
        for name, need in sites.items():
            calls = _calls(fns[name])
            assert need <= calls and need <= helpers, (module, name)
            assert not calls & bare, (module, name, calls & bare)
    prod = _functions(geo / "_products.py")
    assert "fixed_order_bmm" in _calls(prod["matmul"])
    assert "fixed_order_sum" in _calls(prod["row_sum"])
    assert "fixed_order_group" in _calls(prod["matmuls"])
    for name in ("fixed_order_bmm", "fixed_order_sum"):
        assert "fixed_order_group" in _calls(prod[name])
    assert "_launch" in _calls(prod["fixed_order_group"])
    assert "kernels.launch" in _calls(prod["_launch"])


# P5-P8: module -> public function -> (its plain version, its launch
# counter)
SMALL_SOLVER_SITES = {
    "geometry/eig.py": {
        "smallest_eigvec_sym": ("smallest_eigvec_sym_plain",
                                "smallest_eigvec_sym"),
        "eigh3x3_desc": ("eigh3x3_desc_plain", "eigh3x3_desc")},
    "geometry/epipolar.py": {
        "frame_rotations": ("frame_rotations_plain", "essential_frame")},
    "rng.py": {"threefry2x32": ("threefry2x32_plain", "threefry2x32")},
}


def test_small_solvers_reach_their_kernels():
    """Each of P5-P8's public functions takes its plain version on CPU
    tensors and launches its kernel with `kernels.launch` on CUDA tensors,
    with no `try` to fall back by; `essential_frame` reaches P7 through
    `frame_rotations` after its P2 products; the source is built with
    -fmad=false and holds each kernel the launch counters name."""
    from rpe_tpu_torch.ops import kernels

    for module, sites in SMALL_SOLVER_SITES.items():
        path = ROOT / "rpe_tpu_torch" / module
        fns = _functions(path)
        for name, (plain, counter) in sites.items():
            fn = fns[name]
            assert plain in fns, (module, plain)
            assert "kernels.launch" in _calls(fn), (module, name)
            assert plain in _calls(fn), (module, name)
            assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
            launch = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                      and ast.unparse(n.func) == "kernels.launch"]
            assert [ast.literal_eval(c.args[0]) for c in launch] == [counter]
            assert kernels.KERNELS[counter] == "small_solvers"
    assert "frame_rotations" in _calls(
        _functions(ROOT / "rpe_tpu_torch" / "geometry" / "epipolar.py")[
            "essential_frame"])
    src, flags = kernels.SOURCES["small_solvers"]
    assert "-fmad=false" in flags and "--use_fast_math" not in flags
    text = (ROOT / "rpe_tpu_torch" / "csrc" / src).read_text()
    for kernel in ("smallest_eigvec_kernel", "eigh3x3_kernel",
                   "essential_frame_kernel", "threefry_kernel"):
        assert f"{kernel}(" in text or f"{kernel}<" in text, kernel


def test_sift_stages_reach_their_kernels():
    """On the card branch SIFT's orientation histogram and descriptor
    (ops/sift.py `orientation_hist`, `descriptor`) launch P3 and P4 with
    `kernels.launch`, and no torch.matmul, einsum or bmm is left in them
    or in the detection loop, which calls both."""
    fns = _functions(ROOT / "rpe_tpu_torch" / "ops" / "sift.py")
    bare = {"torch.matmul", "torch.einsum", "torch.bmm"}
    for name in ("orientation_hist", "descriptor"):
        calls = _calls(fns[name])
        assert "kernels.launch" in calls, name
        assert not calls & bare, (name, calls & bare)
    loop = _calls(fns["sift_detect_and_describe"])
    assert {"orientation_hist", "descriptor"} <= loop
    assert not loop & bare


class _FakeCudaTensor:
    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


def test_launch_enters_the_tensors_device(monkeypatch):
    """`kernels.launch` hands the launcher the stream of its tensor's
    device, entering that device only when it is not current."""
    from rpe_tpu_torch.ops import kernels

    entered = []

    class _Guard:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            entered.append(self.d)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda d: 1000 + d, raising=False)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    before = kernels.LAUNCHES["fast_harris"]
    calls = []

    def fn(*args):
        calls.append(args)
        return 0

    kernels.launch("fast_harris", fn, _FakeCudaTensor(0), 7, 8)
    assert calls[-1] == (7, 8, 1000) and entered == []
    kernels.launch("fast_harris", fn, _FakeCudaTensor(3), 7, 8)
    assert calls[-1] == (7, 8, 1003) and entered == [3]
    assert kernels.LAUNCHES["fast_harris"] == before + 2
    kernels.LAUNCHES["fast_harris"] = before


def test_resolve_device_names_the_card(monkeypatch):
    """A CUDA device always comes back indexed, so the per-device caches
    (`_device_tan_grid`, `_brief_tables_on`) are keyed on a real card."""
    from rpe_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert resolve_device(None) == torch.device("cuda", 2)
    assert resolve_device("cuda") == torch.device("cuda", 2)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 2)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
