"""The controls on the card at each cell's own size: the reference one
precision below the configuration's (fp8 products) in the program's place
fails the cell's committed limits on three seeds.  Needs a CUDA card."""
import pytest

from yardstick import control, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
def test_control_fails_on_the_card(cell, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    c = spec.load_cell(cell)
    numbers = control.CONTROLS[c.traffic["kind"]](c, seed, torch.device("cuda", 0))
    torch.cuda.empty_cache()
    assert any(numbers[k] > c.limits[k] for k in c.limits), numbers
