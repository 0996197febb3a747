"""Every cell of the manifest for a short window on the card: a result
with the contract's keys, `correct` true, and the traced run's per-layer
metrics. Skips without a card (the `card` fixture decides).

    python3 -m pytest posebench/tests/test_posebench_gpu.py
"""

import json
import time

import pytest

import harness
import manifest
from helpers import ROOT

M = manifest.load(ROOT)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(card, workload, trace):
    cell = manifest.Cell(M, workload, ROOT)
    r = harness.run(cell, 2 ** 31 + 5, 1.0, trace, card,
                    time.perf_counter(), log=lambda m: None)
    line = json.loads(harness.result_line(r))
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    want = {m["name"] for m in (cell.per_layer if trace else
                                cell.end_to_end)}
    assert set(line["metrics"]) == want
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["metrics"]["kernel_roofline_pct"]["value"] <= 100.0
