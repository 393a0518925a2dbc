"""The port's train step against the JAX package in uncertainty mode and with
a frozen backbone (coc_dryrun, 64^2, batch 2, f32, module-path blocks).  The
fixed-mode case and the tolerances' reasons are in
tests/test_torch_train_step.py and tests/torch_parity.py::check_first_step:
metrics rtol 1e-4 after one step and rtol 1e-3 after a second, parameters
atol 1e-5, BN running stats atol 1e-5 + rtol 1e-5."""
import numpy as np
import pytest
import torch

from tests import torch_parity as tp

from asy_vrnet_tpu_torch.train.train_step import FROZEN_PREFIX


@pytest.fixture(scope="module")
def uncertainty():
    return tp.run_one_step_each("uncertainty")


@pytest.fixture(scope="module")
def frozen():
    return tp.run_one_step_each("fixed", freeze_backbone=True)


def test_uncertainty_first_step_matches_jax(uncertainty):
    tp.check_first_step(uncertainty)
    r = uncertainty
    # log_var took plain SGD at the injected lr, outside the optimiser
    assert float(r["j1"].log_var) != 0.0
    np.testing.assert_allclose(r["t1"].log_var.item(), float(r["j1"].log_var), rtol=1e-4)
    assert all(r["t1"].log_var is not p for g in r["t1"].optimizer.param_groups
               for p in g["params"])


def test_uncertainty_second_step_matches_jax(uncertainty):
    own, bridged = tp.check_second_step(uncertainty)
    for s in (own, bridged):
        np.testing.assert_allclose(s.log_var.item(), float(uncertainty["j2"].log_var),
                                   rtol=1e-3)


def test_frozen_backbone_first_step_matches_jax(frozen):
    tp.check_first_step(frozen)


def test_frozen_backbone_keeps_weights_and_momentum_moves_bn_stats(frozen):
    r = frozen
    start = tp.port_state_from_jax(r["tcfg"], r["j0"])
    before, after = start.model.state_dict(), r["t1"].model.state_dict()
    named = dict(r["t1"].model.named_parameters())
    frozen_keys = [k for k in named if k.startswith(FROZEN_PREFIX)]
    assert frozen_keys and len(frozen_keys) < len(named)
    for k in frozen_keys:
        assert torch.equal(before[k], after[k]), k
        # the bridged momentum (zeros) is as it was: weight decay fed nothing in
        buf = r["t1"].optimizer.state[named[k]]["momentum_buffer"]
        assert torch.equal(buf, torch.zeros_like(buf)), k
    assert any(not torch.equal(before[k], after[k]) for k in named if k.startswith("head."))
    # the frozen part still runs in train mode: its BN running stats move
    stats = [k for k in before if k.startswith(FROZEN_PREFIX) and k.endswith("running_mean")]
    assert stats and all(not torch.equal(before[k], after[k]) for k in stats)


def test_frozen_backbone_second_step_matches_jax(frozen):
    tp.check_second_step(frozen)
