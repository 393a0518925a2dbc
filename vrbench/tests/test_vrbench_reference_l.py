"""test_vrbench_reference.py's forward check (the frozen reference against
the port's plain path on the CPU, in both modes, on the same seeded weights
and inputs) for phi l (`vrnet-l`: published widths 64/128/320/512, neck C
512/640/256) at the same tiny size (`coc_dryrun` depth, 64x64, f32)."""
from __future__ import annotations

import pytest
import torch
from test_vrbench_reference import _cfg
from test_vrbench_reference import test_forward as check_forward

from vrbench import run
from vrbench.traffic import train as train_traffic
from vrbench.weights import make_weights

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup_l():
    cfg = _cfg("vrnet-l")
    mix = {**run.cell_spec("nano-train-b256")[2], "batch": 2, "pool": 1}
    pool = train_traffic.make_pool(cfg, mix, 19, CPU)
    return cfg, mix, pool, make_weights(cfg["model"], 19, CPU)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_l(setup_l, mode):
    check_forward(setup_l, mode)
