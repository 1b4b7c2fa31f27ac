"""The control of ``correct``: the plain reference in the program's place,
computed with TF32 products (one precision step below the configurations'
float32), comes out as not correct under each cell's limits; the float64
reference in the same place comes out correct (the judge passes what it
should)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from port_bench import control  # noqa: E402

#: Each cell at a size the CPU holds.
SMALL = {
    "fleet.loop": {"data.B": 32, "grid.G": 1000, "params.check_problems": 32},
    "large.loop": {"data.n_obs": 120, "model.max_obs": 128, "grid.G": 1000},
    "large.hyper": {"data.n_obs": 60, "model.max_obs": 64, "params.rows": 8},
    "fleet.hyper": {"data.B": 16, "params.rows": 8},
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_tf32_control_is_not_correct(cell):
    res = control.readings(cell, 20240611, "tf32", "cpu", SMALL[cell])
    assert res["correct"] is False, res


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_float64_reference_in_the_programs_place_is_correct(cell):
    res = control.readings(cell, 20240611, "f64", "cpu", SMALL[cell])
    assert res["correct"] is True, res


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_tf32_control_is_not_correct_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    for seed in (101, 202, 303):
        res = control.readings(cell, seed, "tf32", "cuda")
        assert res["correct"] is False, res
