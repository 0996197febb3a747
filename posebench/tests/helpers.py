"""A temporary checkout of the benchmark with a tiny cell of its own, made
by new files and a manifest entry alone, for the CPU tests."""

import contextlib
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {"height": 188, "width": 620, "fx": 359.4, "fy": 359.4,
        "cx": 303.6, "cy": 92.6, "pairs": 3, "pool": 2}

# the harness's run constants for the tests' short runs
SMALL_RUNS = {"WARM_CALLS": 1, "CHECK_CALLS": 1, "CHECK_PAIRS": 2,
              "CHECK_SPAN": 1, "TRACE_FIRST": 1, "TRACE_CALLS": 1}


@contextlib.contextmanager
def small_runs(**kw):
    """The harness's run constants set to SMALL_RUNS (and `kw`) inside."""
    import harness

    saved = {k: getattr(harness, k) for k in SMALL_RUNS}
    for k, v in dict(SMALL_RUNS, **kw).items():
        setattr(harness, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(harness, k, v)


def tiny_checkout(tmp: Path, config: str = "orb4000", **traffic) -> str:
    """Copy BENCHMARK.json and posebench/ under `tmp`, link the program,
    add traffic/tiny.json and the workload <config>.tiny; returns its
    name."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "posebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "rpe_tpu_torch").symlink_to(ROOT / "rpe_tpu_torch")
    base = json.loads((BENCH / "traffic" / "kitti_b32.json").read_text())
    base.update(TINY, name="tiny", **traffic)
    (tmp / "posebench" / "traffic" / "tiny.json").write_text(
        json.dumps(base))
    m = json.loads((tmp / "BENCHMARK.json").read_text())
    if not any(c["name"] == config for c in m["configs"]):
        m["configs"].append({"name": config, "source": "test",
                             "file": f"posebench/configs/{config}.json",
                             "reduced": [], "why": "test"})
    m["workloads"].append({"name": f"{config}.tiny", "config": config,
                           "traffic": "tiny", "chips": 1, "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(m))
    return f"{config}.tiny"


def load_cell(tmp: Path, name: str):
    import manifest

    return manifest.Cell(manifest.load(tmp), name, tmp)
