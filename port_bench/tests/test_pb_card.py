"""The control and the planted faults at each cell's own size, on the
card (skipped without one): the program's readings pass the cell's
limits, the control's and every fault's do not. On the chip:
`python -m pytest -q port_bench/tests/test_pb_card.py` (~2 min)."""
import pytest
import torch

from port_bench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "pb_control", harness.ROOT / "control.py")
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    limits = harness.load_cell(cell)["limits"]

    def passes(numbers):
        return all(numbers[k] <= lim for k, lim in limits.items())

    r = control.readings(cell, 2**31 + 99, control=True, with_faults=True)
    assert passes(r["program"]), r["program"]
    failing = [k for k in r if k not in ("program", "bf16_witness", "losses")
               and not k.endswith(("_detail", "_quantiles"))]
    assert "control" in failing and len(failing) >= 2
    for k in failing:
        assert not passes(r[k]), (k, r[k])
