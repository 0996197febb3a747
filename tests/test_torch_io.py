"""rpe_tpu_torch's host layer against rpe_tpu's: the native image decoder,
LazyFrameSource, the ground-truth loader, camera calibration and the pose
evaluator. PNGs are written by the port's stdlib writer
(rpe_tpu_torch/utils/synthetic.write_png, rows cycling through all five
PNG filters). Decoded pixels are held bit for bit; the evaluator's float64
metrics within 1e-9."""

import sys

import numpy as np
import pytest

from rpe_tpu.io import image_loader as jil
from rpe_tpu.io import native as jnative
from rpe_tpu.pipeline import calibration as jcal
from rpe_tpu.pipeline import evaluator as jev
from rpe_tpu.pipeline import ground_truth as jgt
from rpe_tpu_torch.io import image_loader as til
from rpe_tpu_torch.io import native as tnative
from rpe_tpu_torch.pipeline import calibration as tcal
from rpe_tpu_torch.pipeline import evaluator as tev
from rpe_tpu_torch.pipeline import ground_truth as tgt
from rpe_tpu_torch.utils.synthetic import write_png

H, W = 45, 67


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Three images of each kind: gray, RGB and palette."""
    d = tmp_path_factory.mktemp("png")
    g = np.random.default_rng(5)
    out = {}
    for kind in ("gray", "rgb", "palette"):
        paths = []
        for i in range(3):
            p = d / f"{kind}_{i}.png"
            if kind == "gray":
                write_png(p, g.integers(0, 256, (H, W), dtype=np.uint8))
            elif kind == "rgb":
                write_png(p, g.integers(0, 256, (H, W, 3), dtype=np.uint8))
            else:
                write_png(p, g.integers(0, 40, (H, W), dtype=np.uint8),
                          palette=g.integers(0, 256, (40, 3), dtype=np.uint8))
            paths.append(str(p))
        out[kind] = paths
    return out


@pytest.mark.parametrize("kind", ["gray", "rgb", "palette"])
@pytest.mark.parametrize("to_gray", [True, False], ids=["gray_out", "bgr_out"])
def test_native_decoder_bit_equal_to_reference_and_pil(pngs, kind, to_gray):
    from PIL import Image

    paths = pngs[kind]
    got = tnative.decode_batch(paths, to_gray=to_gray)
    np.testing.assert_array_equal(got, jnative.decode_batch(paths,
                                                            to_gray=to_gray))
    for p, im in zip(paths, got):
        pil = Image.open(p)
        want = np.asarray(pil.convert("L")) if to_gray else \
            np.asarray(pil.convert("RGB"))[..., ::-1]
        np.testing.assert_array_equal(im, want)
    assert got.shape == ((3, H, W) if to_gray else (3, H, W, 3))


def test_load_image_batch_counts_native_decodes(pngs, monkeypatch):
    til.reset_decodes()
    a = til.load_image_batch(pngs["rgb"])
    assert til.DECODES == {"native": 3, "pil": 0}
    monkeypatch.setenv("RPE_NO_NATIVE_LOADER", "1")
    b = til.load_image_batch(pngs["rgb"])
    assert til.DECODES == {"native": 3, "pil": 3}
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, jil.load_image_batch(pngs["rgb"]))


def test_pil_path_without_pil_names_the_file(pngs, monkeypatch):
    monkeypatch.setenv("RPE_NO_NATIVE_LOADER", "1")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="gray_0.png"):
        til.load_image_batch(pngs["gray"][:1])


def test_missing_file_raises(pngs, tmp_path):
    missing = str(tmp_path / "nope.png")
    for paths in ([missing], [pngs["gray"][0], missing]):
        with pytest.raises(FileNotFoundError, match="nope.png"):
            til.load_image_batch(paths)
        with pytest.raises(FileNotFoundError):
            jil.load_image_batch(paths)
    with pytest.raises(FileNotFoundError, match="nope.png"):
        til.LazyFrameSource([missing]).get([0])


def test_failed_decoder_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.decode_batch([str(bad)])


def test_decoder_builds_into_the_build_dir_from_its_own_source():
    lib = tnative.load_library()
    so = tnative._lib_path()
    assert so.exists() and so.parent.name == "build"
    assert so.parent.parent.name == "csrc"
    assert tnative._SRC.parent.name == "native"
    assert tnative._SRC.parent.parent.name == "io"
    assert lib is tnative.load_library()


def test_lazy_frame_source_equals_eager_and_caches(pngs):
    paths = pngs["gray"] + pngs["palette"]
    eager = np.stack([np.asarray(til.load_image(p), np.float32)
                      for p in paths])
    src = til.LazyFrameSource(paths, to_gray=True, cache_frames=4)
    ref = jil.LazyFrameSource(paths, to_gray=True, cache_frames=4)
    til.reset_decodes()
    first = src[[0, 1, 2]]
    assert til.DECODES["native"] == 3
    again = src.get([1, 2, 3])                    # 1, 2 cached
    assert til.DECODES["native"] == 4
    assert first.dtype == np.float32
    np.testing.assert_array_equal(first, eager[:3])
    np.testing.assert_array_equal(again, eager[1:4])
    idx = np.array([[0, 5], [3, 3]])              # 2-D index, evicts
    np.testing.assert_array_equal(src[idx], eager[idx])
    assert len(src._cache) <= 4
    np.testing.assert_array_equal(src[1:4], ref[1:4])
    np.testing.assert_array_equal(src.get(list(range(6))),
                                  ref.get(list(range(6))))   # bypass
    assert len(src) == 6


@pytest.fixture(scope="module")
def gt_file(tmp_path_factory):
    g = np.random.default_rng(9)
    p = tmp_path_factory.mktemp("gt") / "camera_poses.txt"
    frames = np.arange(0, 60, 3)
    rows = ["frame x y z roll pitch yaw"]
    for f in frames:
        x, y, z = g.normal(size=3) * 5
        r, pi, ya = g.uniform(-30, 30, 3)
        rows.append(f"{f} {x:.6f} {y:.6f} {z:.6f} {r:.5f} {pi:.5f} {ya:.5f}")
    p.write_text("\n".join(rows) + "\n")
    return p


def test_ground_truth_loader_equals_reference(gt_file):
    t, j = tgt.GroundTruthLoader(gt_file), jgt.GroundTruthLoader(gt_file)
    with pytest.raises(RuntimeError, match="load"):
        t.get_pose(0)
    data, df = t.load(), j.load()
    assert list(data) == list(df.columns)
    for k in data:
        np.testing.assert_array_equal(data[k], df[k].values)
        assert data[k].dtype == df[k].values.dtype, k
    for f in (0, 9, 57):
        assert t.get_pose(f) == j.get_pose(f)
    with pytest.raises(KeyError, match="Frame 4 not found"):
        t.get_pose(4)
    for step in (1, 2, 6, 15):
        for name in ("get_frame_indices", "get_trajectory",
                     "get_orientations"):
            a = getattr(t, name)(step=step)
            b = getattr(j, name)(step=step)
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype, name
    np.testing.assert_array_equal(t.get_all_frames(), j.get_all_frames())
    frames = [12, 0, 57, 12]
    for a, b in zip(t.poses_for_frames(frames), j.poses_for_frames(frames)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.float64
    with pytest.raises(KeyError, match="Frame 5 not found"):
        t.poses_for_frames([0, 5])


def test_camera_calibration_equals_reference(tmp_path):
    for kw in ({}, {"camera_matrix": np.diag([500.0, 510.0, 1.0])}):
        a, b = tcal.CameraCalibration(**kw), jcal.CameraCalibration(**kw)
        np.testing.assert_array_equal(a.get_matrix(1241, 376),
                                      b.get_matrix(1241, 376))
        img = np.zeros((376, 1241))
        np.testing.assert_array_equal(a.get_matrix_from_image(img),
                                      b.get_matrix_from_image(img))
    with pytest.raises(ValueError):
        tcal.CameraCalibration().get_matrix()
    with pytest.raises(ValueError):
        tcal.CameraCalibration(camera_matrix=np.eye(4))
    K = np.array([[700.0, 0, 320], [0, 705, 240], [0, 0, 1]])
    np.savez(tmp_path / "k.npz", K=K)
    np.savez(tmp_path / "flat.npz", intrinsic_matrix=K.reshape(-1))
    np.savez(tmp_path / "none.npz", other=K)
    np.testing.assert_array_equal(
        tcal.CameraCalibration(calibration_file=tmp_path / "k.npz")
        .get_matrix(), K)
    for f in ("k.npz", "flat.npz"):
        np.testing.assert_array_equal(tcal.load_K_npz(tmp_path / f),
                                      jcal.load_K_npz(tmp_path / f))
    with pytest.raises(KeyError):
        tcal.load_K_npz(tmp_path / "none.npz")
    with pytest.raises(KeyError):
        tcal.CameraCalibration(calibration_file=tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError):
        tcal.CameraCalibration(calibration_file=tmp_path / "missing.npz")


@pytest.mark.parametrize("conv", ["yup", "zyx"])
def test_pose_evaluator_equals_reference(gt_file, conv, capsys):
    j = jgt.GroundTruthLoader(gt_file)
    j.load()
    t = tgt.GroundTruthLoader(gt_file)
    t.load()
    frames = [3, 6, 9, 12, 15, 18]
    _, rpy = j.poses_for_frames(frames)
    g = np.random.default_rng(1)
    est_rpy = rpy + g.normal(size=rpy.shape) * 2.0
    est_rpy[2, 2] += 350.0                       # a wrapped yaw
    from rpe_tpu.geometry.rotations import euler_to_rotation_np

    R = euler_to_rotation_np(est_rpy[:, 2], est_rpy[:, 1], est_rpy[:, 0],
                             convention=conv)
    res = {"frames": frames, "roll": est_rpy[:, 0].astype(np.float32),
           "pitch": est_rpy[:, 1], "yaw": est_rpy[:, 2],
           "R": list(R), "t": list(g.normal(size=(6, 3, 1)))}
    ev_t = tev.PoseEvaluator(t, euler_convention=conv)
    ev_j = jev.PoseEvaluator(j, euler_convention=conv)
    a, b = ev_t.evaluate_sequence(res), ev_j.evaluate_sequence(res)
    assert a.keys() == b.keys()
    assert a["frames"] == b["frames"]
    for k in a:
        if k != "frames":
            assert np.asarray(a[k]).dtype == np.float64, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-9,
                                       err_msg=k)
    assert a["translation_dir_error"][0] == 0.0
    sa, sb = (ev.compute_summary_statistics(a) for ev in (ev_t, ev_j))
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k] == pytest.approx(sb[k], rel=0, abs=1e-9), k
    capsys.readouterr()
    ev_t.print_summary(a)
    out_t = capsys.readouterr().out
    ev_j.print_summary(b)
    assert out_t == capsys.readouterr().out
    df_t = ev_t.create_comparison_dataframe(a)
    assert list(df_t.columns) == list(ev_j.create_comparison_dataframe(
        b).columns)


def test_comparison_frame_without_pandas_raises(gt_file, monkeypatch):
    t = tgt.GroundTruthLoader(gt_file)
    t.load()
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        tev.PoseEvaluator(t).create_comparison_dataframe({"frames": []})
