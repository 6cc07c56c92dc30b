"""The control of each cell, on the card at the cell's own size: the plain
reference in the program's place, computed in float8, comes out not
correct. Run on the card:

    python -m pytest portbench/tests -m gpu -q -p no:cacheprovider
"""

import pytest

from portbench import control
from portbench.core import registry

CELLS = [w["name"] for w in registry.load_json(f"{registry.ROOT}/BENCHMARK.json")["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = registry.find_cell(name)
    (row,) = control.readings(cell, "control", [20261018], 10.0)
    failed = {k: v for k, v in row["check"].items() if v > cell.limits[k]}
    assert failed, row["check"]
