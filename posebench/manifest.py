"""The benchmark's manifest (`BENCHMARK.json` at the checkout's root) and
the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own under `posebench/`, found by name:

  configuration `c`  -> the file its manifest entry names (configs/c.json),
                        its limits limits/c.json, and its plain reference
                        reference/<the config's "reference">.py
  traffic `t`        -> traffic/t.json
  per-layer metric m -> metrics/m.py, whose `read(trace)` returns a number
                        or None

So a later cell, configuration or metric is added by new files and new
manifest entries, without an edit to a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class ManifestError(RuntimeError):
    pass


def load(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise ManifestError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _one(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise ManifestError(f"{what} {name!r}: {len(found)} entries")
    return found[0]


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise ManifestError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """Import the Python file `path` as module `name`."""
    if not path.is_file():
        raise ManifestError(f"no module file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with every file it needs, resolved."""

    def __init__(self, manifest: dict, workload: str, root: Path = ROOT):
        self.root = root
        self.entry = _one(manifest["workloads"], workload, "workload")
        self.name = workload
        self.chips = int(self.entry["chips"])
        cfg_entry = _one(manifest["configs"], self.entry["config"],
                         "configuration")
        self.config = _json(root / cfg_entry["file"], "configuration")
        self.config_name = cfg_entry["name"]
        bench = root / "posebench"
        self.traffic = _json(bench / "traffic" / f"{self.entry['traffic']}.json",
                             "traffic")
        self.limits = _json(bench / "limits" / f"{self.config_name}.json",
                            "limits")
        self.reference_path = (bench / "reference"
                               / f"{self.config['reference']}.py")
        if not self.reference_path.is_file():
            raise ManifestError(f"no reference {self.reference_path}")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.readers = {}
        for m in self.per_layer:
            self.readers[m["name"]] = bench / "metrics" / f"{m['name']}.py"
            if not self.readers[m["name"]].is_file():
                raise ManifestError(f"no reader {self.readers[m['name']]}")

    def reader(self, metric: str):
        return load_module(self.readers[metric],
                           "posebench_metric_" + metric.replace(".", "_"))

    def reference(self):
        """The configuration's plain reference, posebench/reference/<name>.py
        (a module of the `reference` package, posebench/ on sys.path)."""
        import importlib

        return importlib.import_module("reference." + self.config["reference"])
