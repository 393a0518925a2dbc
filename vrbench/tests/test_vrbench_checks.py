"""The check that decides `correct`, at a size a CPU test run holds
(`coc_dryrun`, 64x64, f32, a few rows), under each cell's own limits:

- a sound run of the whole harness (everything but the look for a card)
  comes out correct;
- the same run with the timed path broken underneath comes out not correct,
  for each fault the cell can have: a train step that returns its state
  unchanged, half of each batch left out (the mean over the rest), the
  detections' classes altered where the pipeline produces them, NMS that
  suppresses nothing;
- the control, the reference computed with fp8 operands in the program's
  place, fails at least one of the cell's numbers.
"""
from __future__ import annotations

import pytest
import torch

from vrbench import calibrate, run

CPU = torch.device("cpu")
TINY = {"model": {"variant": "coc_dryrun", "input_size": [64, 64], "compute_dtype": "float32"}}
MIX = {"train": {"batch": 4, "pool": 3, "trace_iters": 1},
       "serve": {"batch": 2, "pool": 2, "frame_hw": [96, 128], "radar_points": 64,
                 "valid_points": [8, 64], "early_requests": 2, "sampled_requests": 1,
                 # at 64x64 a lower threshold leaves enough overlapping
                 # candidates for NMS to suppress
                 "conf_thres": 0.1,
                 "warmup_requests": 1, "trace_iters": 1}}
FAULTS = {"train": ("unchanged", "half_batch"),
          "serve": ("half_batch", "altered", "no_suppression")}
CELLS = ("nano-train-b256", "s-serve-b256")
SEED = 2 ** 31 + 5


def _kind(cell):
    return run.cell_spec(cell)[2]["kind"]


def _overrides(cell):
    return {**TINY, "mix": MIX[_kind(cell)]}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run.run_cell(cell, SEED, 0.3, True, CPU, overrides=_overrides(cell))
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(run.cell_spec(cell)[0]["limits"])
    assert res["metrics"] and res["attempted"] >= 1


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[_kind(c)]])
def test_broken_timed_path_is_not_correct(cell, fault):
    res = run.run_cell(cell, SEED, 0.3, False, CPU, overrides=_overrides(cell), fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    limits = run.cell_spec(cell)[0]["limits"]
    rows = calibrate.readings(cell, 0, 1, CPU, SEED, overrides=_overrides(cell))["control"]
    assert any(row[k] > limits[k] for row in rows for k in limits if limits[k] is not None)
