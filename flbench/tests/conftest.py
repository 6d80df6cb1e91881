"""The benchmark's own tests: ``python -m pytest flbench/tests`` from the
root of the repository.  CPU tests run the harness at a small size with
the kernels' plain versions; tests marked ``gpu`` need a CUDA card."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE.parent.parent / "src"))

#: a size a CPU test run can hold: 6 devices of 32 samples, minibatches of
#: 8 (4 local steps)
SMALL = {"data": {"n_train": 192, "n_test": 64}, "fleet": {"n_devices": 6},
         "traffic": {"batch_size": 8}}


@pytest.fixture
def small(request):
    """A size a CPU test run can hold: the ``small`` groups of the cell's
    settings (``workloads/<cell>.json``) where the test is run for a
    cell that has them, :data:`SMALL` otherwise."""
    sizes = SMALL
    cell = getattr(getattr(request.node, "callspec", None), "params",
                   {}).get("cell")
    if cell is not None:
        import json
        settings = json.loads((HERE.parent / "workloads"
                               / f"{cell}.json").read_text())
        sizes = settings.get("small", SMALL)
    return {k: dict(v) for k, v in sizes.items()}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
