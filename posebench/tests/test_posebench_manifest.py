"""The manifest against the benchmark's contract, every file it names
found by name, a cell added by new files alone, and no import of JAX or
the JAX package anywhere under posebench/."""

import ast
import json
import re

import pytest

import manifest
from helpers import BENCH, ROOT, load_cell, tiny_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["posebench"]
    assert 1 <= M["run_seconds"] <= 51
    assert all(LINE.match(w) for w in M["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"})])
def test_entries(section, keys):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for e in M[section]:
        assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert LINE.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"])


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert set(e2e) == {"pairs_per_s", "setup_s"}
    assert 0.01 <= e2e["pairs_per_s"]["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in M["end_to_end"])
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = manifest.Cell(M, workload, ROOT)
    assert cell.traffic["name"] == cell.entry["traffic"]
    assert cell.config["name"] == cell.entry["config"]
    assert set(cell.limits) >= {"invalid_pairs", "pose_off"}
    assert cell.reference().numbers
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s",
                                                     "setup_s"}


def test_config_files():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith("posebench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_cell_added_by_new_files_alone(tmp_path):
    before = {p: p.read_bytes() for p in BENCH.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    name = tiny_checkout(tmp_path)
    cell = load_cell(tmp_path, name)
    assert cell.traffic["width"] == 620
    copied = {p.relative_to(BENCH): b for p, b in before.items()}
    for rel, data in copied.items():
        assert (tmp_path / "posebench" / rel).read_bytes() == data
    added = {p.relative_to(tmp_path / "posebench")
             for p in (tmp_path / "posebench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts} - set(copied)
    assert {str(p) for p in added} == {"traffic/tiny.json"}


FORBIDDEN = {"jax", "jaxlib", "flax", "rpe_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "rpe_tpu_torch" not in set(_imports(path))


def test_top_level_name_compared_whole():
    import harness

    assert "rpe_tpu_torch" not in FORBIDDEN and "rpe_tpu" in FORBIDDEN
    assert set(harness.FORBIDDEN) == FORBIDDEN


@pytest.mark.parametrize("b", [1, 3, 32, 128])
def test_sample_plan(b):
    """The check's sample: calls 1 .. CHECK_SPAN x pool drawn from the
    seed alone, at most CHECK_PAIRS pairs of each, one from each part of
    the chunk."""
    import harness

    calls, pairs = harness.sample_plan(2 ** 31 + 3, 4, b)
    assert (calls, pairs) == harness.sample_plan(2 ** 31 + 3, 4, b)
    assert len(calls) == harness.CHECK_CALLS and 1 <= min(calls)
    assert max(calls) <= harness.CHECK_SPAN * 4
    for c in calls:
        q = min(harness.CHECK_PAIRS, b)
        assert len(pairs[c]) == q
        assert all(j * b // q <= p < max((j + 1) * b // q, j * b // q + 1)
                   for j, p in enumerate(pairs[c]))
