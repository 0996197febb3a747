"""rpe_tpu_torch's orchestrator, visualizer, dataset runners and flat API
against rpe_tpu on the CPU.

One sequence (utils/synthetic.py `make_sequence`, 3 frames of 188x620,
seed 6) is written in the three dataset layouts (simulator, phone and Salah;
the phone and Salah calibrations as .npz files), and both packages' runners
run on it at their defaults (parity profile, VP refinement on, host twin)
with `--step 1 --chunk 2 --no-video`; the single-pair runner on two of its
frames.

Contracts:
- Runners and PoseEstimationPipeline: the same frames and `valid`; each
  pair's world rotation within 0.5 deg of the reference's and each Euler
  angle and error within 0.5 deg, the per-pair bound
  tests/test_torch_kitti_runner.py holds (a BRIEF bit that float32 steering
  rounds the other way can move a pose by tenths of a degree); the same
  artifacts.
- `evaluation_results.csv` is byte-equal to pandas' `to_csv(index=False)`
  of the same evaluation results (the port writes it with `csv`).
- `orientation_plot.html`: the writer's output byte-equal to the
  reference's on the same arrays; end to end, the file outside its data
  byte-equal and the arrows within 1e-6 (the float32 sines of the arrows'
  rotations differ in their last bit between XLA and PyTorch).
- `create_video` without PIL raises an ImportError naming PIL before it
  reads a frame, as the reference does.
- `rpe_tpu_torch.__all__ == rpe_tpu.__all__`.
"""

import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import rpe_tpu
import rpe_tpu_torch
from rpe_tpu_torch.utils.synthetic import make_sequence, rotation_error_deg, \
    write_dataset
from torch_gates import default_extraction_gates  # noqa: F401
from torch_gates import one_torch_thread  # noqa: F401

LAYOUTS = {
    "simulator": ("simulator-data", None),
    "phone": ("phone-data", "calibration_scaled.npz"),
    "salah": ("vo_dataset_salah", "calibration.npz"),
}
RUNNERS = {"simulator": "run_simulator_data", "phone": "run_phone_data",
           "salah": "run_vo_database_salah"}
ARGS = ["--step", "1", "--chunk", "2", "--no-video"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    frames, K, (R, t) = make_sequence(3, 188, 620, seed=6)
    yaw = 1.5 * np.arange(3)
    centres = np.cumsum(np.tile(t, (3, 1)), axis=0)
    for layout, (name, calib) in LAYOUTS.items():
        write_dataset(root / "evaluation-runs" / name / "data", frames, yaw,
                      centres, calib_name=calib, K=K)
    return root, K


def _main(pkg, name, argv, **kw):
    import importlib

    mod = importlib.import_module(f"{pkg}.cli.{name}")
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = mod.main(argv, **kw)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def runs(dataset):
    root, _ = dataset
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RPE_PLATFORM", "cpu")
        for key, name in RUNNERS.items():
            argv = ["--data-root", str(root)] + ARGS
            ref = _main("rpe_tpu", name, argv + [
                "--results-dir", str(root / "ref" / key)])[0]
            got, text = _main("rpe_tpu_torch", name, argv + [
                "--results-dir", str(root / "port" / key)], device="cpu")
            out[key] = ref, got, text
    return root, out


KEYS = list(RUNNERS)


@pytest.mark.parametrize("key", KEYS)
def test_runner_matches_reference(runs, key):
    root, out = runs
    ref, got, text = out[key]
    e_ref, e_got = ref["estimated"], got["estimated"]
    assert list(e_got["frames"]) == list(e_ref["frames"]) == [1, 2]
    np.testing.assert_array_equal(e_got["valid"], e_ref["valid"])
    assert e_got["valid"].all()
    d = rotation_error_deg(np.stack(e_got["R"]), np.stack(e_ref["R"]))
    assert d.max() < 0.5, d
    for k in ("roll", "pitch", "yaw"):
        np.testing.assert_allclose(e_got[k], e_ref[k], rtol=0, atol=0.5)
    ev_ref, ev_got = ref["evaluation"], got["evaluation"]
    assert list(ev_got["frames"]) == list(ev_ref["frames"])
    for k in ("gt_roll", "gt_pitch", "gt_yaw"):
        np.testing.assert_allclose(ev_got[k], ev_ref[k], rtol=0, atol=1e-12)
    for k in ("roll_error", "pitch_error", "yaw_error", "rotation_error"):
        np.testing.assert_allclose(ev_got[k], ev_ref[k], rtol=0, atol=0.5)
    # the same artifacts, and the run printed the reference's lines
    for f in ("evaluation_results.csv", "orientation_plot.html"):
        assert (root / "port" / key / f).is_file()
        assert (root / "ref" / key / f).is_file()
    assert "[INFO] VP refinement: Enabled" in text
    assert "POSE ESTIMATION EVALUATION SUMMARY" in text
    df = got["comparison_df"]
    assert list(df.columns) == list(ref["comparison_df"].columns)
    assert len(df) == 2


@pytest.mark.parametrize("key", ["simulator", "phone"])
def test_csv_byte_equal_to_pandas(runs, key):
    import pandas as pd

    from rpe_tpu_torch.pipeline.orchestrator import comparison_table

    root, out = runs
    ev = out[key][1]["evaluation"]
    want = pd.DataFrame({
        "frame": ev["frames"],
        **{k: ev[k] for k in (
            "gt_roll", "gt_pitch", "gt_yaw", "est_roll", "est_pitch",
            "est_yaw", "roll_error", "pitch_error", "yaw_error",
            "rotation_error", "translation_dir_error")},
    }).to_csv(index=False)
    got = (root / "port" / key / "evaluation_results.csv").read_text()
    assert got == want
    assert list(comparison_table(ev)) == list(pd.read_csv(io.StringIO(got)))


def test_csv_writer_edge_values(tmp_path):
    """NaN, infinities, tiny and huge values, negative zero and integer
    columns, as pandas writes them."""
    import pandas as pd

    from rpe_tpu_torch.pipeline.orchestrator import write_comparison_csv

    table = {"frame": np.array([0, 15, 30]),
             "a": np.array([np.nan, 1e-5, -0.0]),
             "b": np.array([np.inf, 1e16, 0.1 + 0.2]),
             "c": np.array([123456.789, -np.inf, 5e-324])}
    write_comparison_csv(tmp_path / "t.csv", table)
    assert (tmp_path / "t.csv").read_text() == \
        pd.DataFrame(table).to_csv(index=False)


def test_orientation_plot_matches_reference(runs, tmp_path):
    from rpe_tpu.viz.visualizer import Visualizer as JV
    from rpe_tpu_torch.viz.visualizer import Visualizer as TV

    root, out = runs
    g = np.random.default_rng(0)
    arrays = (g.normal(size=(9, 3)), g.normal(size=(4, 3)),
              g.normal(size=(4, 3)), g.normal(size=(4, 3)))
    labels = ["0-15", "15-30", "30-45", "45-60"]
    JV(tmp_path / "j")._plot_standalone_html(*arrays, labels,
                                             tmp_path / "j.html")
    TV(tmp_path / "t")._plot_standalone_html(*arrays, labels,
                                             tmp_path / "t.html")
    assert (tmp_path / "t.html").read_bytes() == \
        (tmp_path / "j.html").read_bytes()

    # end to end on the same evaluation results and ground truth
    from rpe_tpu_torch.pipeline.ground_truth import GroundTruthLoader

    ev = out["simulator"][1]["evaluation"]
    gt = GroundTruthLoader(root / "evaluation-runs/simulator-data/data/"
                           "camera_poses.txt")
    gt.load()
    kw = dict(gt_trajectory_full=gt.get_trajectory(step=1),
              gt_trajectory_filtered=gt.get_trajectory(step=1),
              gt_orientations_filtered=gt.get_orientations(step=1),
              evaluation_results=ev, step=1)
    with redirect_stdout(io.StringIO()):
        pj = JV(tmp_path / "ej").plot_3d_trajectory(**kw)
        pt = TV(tmp_path / "et").plot_3d_trajectory(**kw)
    hj, ht = open(pj).read(), open(pt).read()
    cut = "const DATA = "
    head_j, rest_j = hj.split(cut)
    head_t, rest_t = ht.split(cut)
    assert head_t == head_j
    dj, tail_j = rest_j.split(";\n", 1)
    dt, tail_t = rest_t.split(";\n", 1)
    assert tail_t == tail_j
    dj, dt = json.loads(dj), json.loads(dt)
    assert dt.keys() == dj.keys() and dt["labels"] == dj["labels"]
    for k in ("path", "anchors", "gt", "est"):
        np.testing.assert_allclose(np.asarray(dt[k]), np.asarray(dj[k]),
                                   rtol=0, atol=1e-6)


def test_pipeline_setup_and_single_pair(runs, tmp_path):
    """PoseEstimationPipeline directly (the runners drive its setup and
    run): run before setup raises, and run_single_pair's pair (0, 1) takes
    the sequence's first key and so its pose."""
    from rpe_tpu_torch.pipeline.orchestrator import PoseEstimationPipeline

    root, out = runs
    data = root / "evaluation-runs/simulator-data/data"
    p = PoseEstimationPipeline(data_dir=data, results_dir=tmp_path,
                               device="cpu")
    with pytest.raises(RuntimeError, match="Call setup"):
        p.run(step=1)
    with redirect_stdout(io.StringIO()) as buf:
        p.setup()
        pair = p.run_single_pair(0, 1, show_debug=True)
    assert "[DEBUG] Number of matches:" in buf.getvalue()
    assert set(pair) == {"R", "t", "yaw", "pitch", "roll", "gt_pose1",
                         "gt_pose2"}
    assert pair["gt_pose2"]["yaw"] == 1.5
    R_seq = out["simulator"][1]["estimated"]["R"][0]
    assert rotation_error_deg(pair["R"], R_seq) < 0.5


def test_comparison_without_pandas_is_a_dict(runs, monkeypatch, tmp_path):
    """Where pandas does not import (the card machine), `run` returns the
    12 columns as numpy arrays and writes the same CSV."""
    from rpe_tpu_torch.pipeline.orchestrator import COMPARISON_COLUMNS, \
        PoseEstimationPipeline

    root, out = runs
    estimated = out["simulator"][1]["estimated"]
    data = root / "evaluation-runs/simulator-data/data"
    p = PoseEstimationPipeline(data_dir=data, results_dir=tmp_path,
                               device="cpu")
    with redirect_stdout(io.StringIO()):
        p.setup()
        monkeypatch.setattr(p.batch_processor, "process_at_interval",
                            lambda step: estimated)
        monkeypatch.setitem(sys.modules, "pandas", None)
        got = p.run(step=1, create_plot=False)
    df = got["comparison_df"]
    assert isinstance(df, dict) and tuple(df) == COMPARISON_COLUMNS
    assert all(isinstance(v, np.ndarray) and len(v) == 2 for v in df.values())
    assert not (tmp_path / "orientation_plot.html").exists()
    assert (tmp_path / "evaluation_results.csv").read_bytes() == \
        (root / "port" / "simulator" / "evaluation_results.csv").read_bytes()


def test_create_video_without_pil_names_it(monkeypatch, tmp_path):
    from rpe_tpu_torch.viz.visualizer import Visualizer

    monkeypatch.setitem(sys.modules, "PIL", None)
    ev = {"frames": [1], "gt_roll": [0.0], "gt_pitch": [0.0],
          "gt_yaw": [0.0], "est_roll": [0.0], "est_pitch": [0.0],
          "est_yaw": [0.0]}
    with pytest.raises(ImportError, match="PIL"):
        Visualizer(tmp_path).create_video(tmp_path / "missing", ev)


def test_single_pair_runner_matches_reference(dataset):
    """VP is on but there is no previous rotation: the plain pose."""
    root, K = dataset
    images = root / "evaluation-runs/phone-data/data/images"
    argv = ["--img1", str(images / "000000.png"), "--img2",
            str(images / "000001.png"), "--calibration",
            str(root / "evaluation-runs/phone-data/data/"
                "calibration_scaled.npz")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RPE_PLATFORM", "cpu")
        (Rj, tj), _ = _main("rpe_tpu", "run_single_pair", argv)
    (Rt, tt), text = _main("rpe_tpu_torch", "run_single_pair", argv,
                           device="cpu")
    assert "=== Relative Pose Estimation ===" in text
    assert Rt.shape == (3, 3) and tt.shape == (3, 1)
    assert rotation_error_deg(Rt, Rj) < 0.5
    cos = float(np.clip(np.sum(tt * tj), -1.0, 1.0))
    assert np.degrees(np.arccos(cos)) < 2.0


def test_flat_api_names_match_reference():
    assert rpe_tpu_torch.__all__ == rpe_tpu.__all__
    for name in rpe_tpu_torch.__all__:
        assert getattr(rpe_tpu_torch, name) is not None
    assert rpe_tpu_torch.VpConfig().max_pairs == rpe_tpu.VpConfig().max_pairs
