"""The control (the references computed in fp8 in the program's place)
fails the comparison that a sound run passes, at tiny sizes on the CPU.
On the card, ``control.py`` reads it at each cell's own size."""

import pytest
import torch

from bench_torch import control
from bench_torch.tests import tiny
from bench_torch.tests.test_faults import CELLS


@pytest.mark.parametrize("name", list(CELLS))
def test_control_fails(name, tmp_path):
    cfg_name, tr_name, over = CELLS[name]
    cfg = tiny.config(cfg_name)
    nums = control.control_numbers(tiny.spec(), name, 2_900_000_017, 2.5, "cpu", cfg=cfg,
                                   tr=tiny.traffic(tr_name, **over), cache_dir=tmp_path)
    limits = cfg["limits"]
    assert any(v > limits[k] for k, v in nums.items()), nums
    assert all(v == 0 for k, v in nums.items() if limits[k] == 0), nums
