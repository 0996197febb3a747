"""Autouse fixtures for the rpe_tpu_torch test files that run ORB:

    from torch_gates import default_extraction_gates  # noqa: F401
    from torch_gates import one_torch_thread  # noqa: F401

The port reads the reference's extraction gates from the environment at
call time, and some of the reference's tests set them and leave them set
(tests/test_pooled_band.py leaves RPE_PALLAS_INTERPRET and RPE_EXTRACT_T*
at "0"), so a later test file on the same worker would take another route.
"""

import os
import re

import pytest
import torch

_GATE = re.compile(r"RPE_(.*EXTRACT.*|PALLAS_.*|NO_.*|BRIEF.*)")


@pytest.fixture(autouse=True, scope="module")
def default_extraction_gates():
    """Removes every RPE_*EXTRACT*, RPE_PALLAS_*, RPE_NO_* and RPE_BRIEF*
    variable for the module (its module-scoped fixtures included) and puts
    them back after it; tests set gates with `monkeypatch`."""
    with pytest.MonkeyPatch.context() as mp:
        for name in list(os.environ):
            if _GATE.fullmatch(name):
                mp.delenv(name, raising=False)
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Runs the module's CPU torch work on one thread and puts the count
    back after it. The suite runs one file per worker, several at once, and
    PyTorch's default of a thread per core in every worker oversubscribes
    the cores; the port's small CPU shapes also run faster on one thread
    (tests/test_torch_pipeline.py: 88 s against ~110 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
