"""The slice as a whole: one train step through the fused ClusterBlocks
(`use_pallas_cluster=True`, the JAX package's default) in each package, from
the same state, at coc_dryrun 128^2, batch 2, f32.

JAX runs its Pallas block kernels (forward with the residual pack, and both
backward kernels) in interpret mode; the port runs their plain twins.  At
128^2 ten of the eleven ClusterBlocks take the fused path (p5's regions hold
4 tokens) and JAX takes no lane fold.  Tolerances are
tests/torch_parity.py::check_first_step's: metrics rtol 1e-4; parameters and
their EMA atol 1e-5; BN running stats atol 1e-5 + rtol 1e-5.
"""
import pytest

from tests import torch_parity as tp

from asy_vrnet_tpu_torch.ops import block as tb

SIZE = 128


@pytest.fixture(scope="module")
def fused_step():
    calls = {"mixer_block_bwd": 0, "mlp_block_bwd": 0}

    def counted(name):
        real = getattr(tb, name)

        def fn(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return fn

    with pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(tb, name, counted(name))
        r = tp.run_one_step_each("fixed", size=SIZE, use_pallas_cluster=True)
    r["bwd_calls"] = calls
    return r


def test_fused_train_step_matches_jax(fused_step):
    tp.check_first_step(fused_step)
    assert float(fused_step["tm1"]["num_fg"]) > 0


def test_fused_train_step_took_the_fused_blocks(fused_step):
    assert fused_step["fused"] == [True] * 8 + [False, True, True]
    assert fused_step["bwd_calls"] == {"mixer_block_bwd": 10, "mlp_block_bwd": 10}
    assert not any(tb.LAUNCHES.values())       # the CPU runs the plain twins


def test_frozen_backbone_and_eval_step_through_the_fused_blocks(monkeypatch):
    """Port only, coc_dryrun 64^2: with the fused blocks, `freeze_backbone`
    still leaves the backbone's weights as they were (its grads are dropped
    after the fused backward) while the head moves, and `build_eval_step`
    runs the fused halves without asking for the residual pack."""
    import numpy as np
    import torch

    from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig
    from asy_vrnet_tpu_torch.data.synthetic import make_batch
    from asy_vrnet_tpu_torch.train import state as tstate
    from asy_vrnet_tpu_torch.train import train_step as tts
    from asy_vrnet_tpu_torch.train.optim import set_learning_rate

    cfg = Config(model=ModelConfig(variant="coc_dryrun", compute_dtype="float32",
                                   input_size=(64, 64)),
                 loss=LossConfig(max_boxes=16, use_pallas_seg=True))
    assert cfg.model.use_pallas_cluster
    torch.manual_seed(0)
    state = tstate.create_train_state(cfg, device="cpu")
    set_learning_rate(state.optimizer, 1e-2)
    asked = []
    real = tb.mixer_block

    def spy(*a, return_residuals=False, **kw):
        asked.append(return_residuals)
        return real(*a, return_residuals=return_residuals, **kw)

    monkeypatch.setattr(tb, "mixer_block", spy)
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    batch = make_batch(np.random.default_rng(0), 2, (64, 64), max_boxes=16)
    state, m = tts.build_train_step(cfg, freeze_backbone=True, device="cpu")(state, batch)
    assert asked and all(asked) and np.isfinite(float(m["loss"]))
    after = dict(state.model.named_parameters())
    for k, v in before.items():
        if k.startswith(tts.FROZEN_PREFIX):
            assert torch.equal(v, after[k]), k
    assert any(not torch.equal(v, after[k]) for k, v in before.items() if k.startswith("head."))
    asked.clear()
    got = tts.build_eval_step(cfg, device="cpu")(state, batch)
    assert asked and not any(asked) and np.isfinite(float(got["loss"]))
