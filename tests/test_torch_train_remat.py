"""`ModelConfig.train_remat` in the port: one train step of a coc_dryrun
model (f32, fused ClusterBlocks through their plain twins on the CPU) under
"fusion", "blocks" and "stages" against the same step under "none", and
"blocks" against the JAX package's "blocks".  At 128^2 all 8 backbone
blocks and 2 of the 3 neck blocks take the fused path; the drop-path cases
run at 64^2, where every block takes the module path in training anyway.

A rematerialised span recomputes the same eager ops on the same inputs in
the backward, so loss, every gradient and the BatchNorm running stats agree
with "none" to f32 rounding: atol 1e-6 (measured: bit-equal).  With
drop-path drawing from an explicit generator the recompute must replay the
forward's draws, or the backward differentiates other masks; the drop-path
rate there is 0.6 so that a redraw changes some mask.  The JAX comparison
has check_first_step's tolerances (tests/torch_parity.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig, OptimConfig
from asy_vrnet_tpu_torch.data.synthetic import make_batch
from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
from asy_vrnet_tpu_torch.models.layers import set_generator
from asy_vrnet_tpu_torch.ops import block as tb
from asy_vrnet_tpu_torch.train.optim import set_learning_rate
from asy_vrnet_tpu_torch.train.state import create_train_state
from asy_vrnet_tpu_torch.train.train_step import build_train_step

SIZE = 128        # fused backbone blocks
DROP_SIZE = 64    # drop-path: module-path blocks
SETTINGS = ("fusion", "blocks", "stages")


def _cfg(remat, variant="coc_dryrun", size=SIZE):
    return Config(model=ModelConfig(variant=variant, compute_dtype="float32",
                                    input_size=(size, size), train_remat=remat),
                  loss=LossConfig(max_boxes=16, use_pallas_seg=True),
                  optim=OptimConfig(init_lr=1e-2))


def _step(remat, variant="coc_dryrun", drop_seed=None, size=SIZE):
    """One train step from the same weights and batch -> (metrics, grads, BN
    running stats, updated parameters), all as CPU tensors."""
    cfg = _cfg(remat, variant, size)
    torch.manual_seed(0)
    state = create_train_state(cfg, device="cpu")
    set_learning_rate(state.optimizer, 1e-2)
    if drop_seed is not None:
        set_generator(state.model, torch.Generator().manual_seed(drop_seed))
    batch = make_batch(np.random.default_rng(3), 2, (size, size), max_boxes=16)
    state, m = build_train_step(cfg, device="cpu")(state, batch)
    model = state.model
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return {k: float(v) for k, v in m.items()}, grads, stats, params


def _assert_same(got, want):
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-6, msg=k) \
                    if torch.is_tensor(a[k]) else np.testing.assert_allclose(
                        a[k], b[k], rtol=0, atol=1e-6, err_msg=k)


def _counted(monkeypatch, names):
    calls = {n: 0 for n in names}
    for n in names:
        real = getattr(tb, n)

        def fn(*a, _n=n, _r=real, **kw):
            calls[_n] += 1
            return _r(*a, **kw)
        monkeypatch.setattr(tb, n, fn)
    return calls


@pytest.fixture(scope="module")
def plain_step():
    return _step("none")


@pytest.mark.parametrize("remat", SETTINGS)
def test_remat_step_equals_none(remat, plain_step, monkeypatch):
    """Loss, every gradient, the running stats (updated once, not again by
    the recompute) and the updated parameters as under "none"; the fused
    blocks' mixer forward runs again for each recomputed backbone block."""
    calls = _counted(monkeypatch, ("mixer_block", "mlp_block"))
    got = _step(remat)
    _assert_same(got, plain_step)
    # 10 fused blocks; the 8 in the backbone run their mixer half again in
    # the recompute (the neck is never rematerialised)
    again = {"fusion": 0, "blocks": 8, "stages": 8}[remat]
    assert calls == {"mixer_block": 10 + again, "mlp_block": 10}


@pytest.mark.parametrize("remat", ("blocks", "stages"))
def test_remat_replays_droppath_generator(remat, monkeypatch):
    """Drop-path from an explicit generator: the recompute replays the
    forward's masks, so every gradient is that of "none" from the same
    generator seed."""
    tp.register_droppath_variant(monkeypatch, rate=0.6)
    want = _step("none", tp.DROPPATH_VARIANT, drop_seed=7, size=DROP_SIZE)
    got = _step(remat, tp.DROPPATH_VARIANT, drop_seed=7, size=DROP_SIZE)
    _assert_same(got, want)


def test_remat_leaves_the_generator_where_the_forward_left_it(monkeypatch):
    """After the step, the generator has drawn what the forward drew, no
    more: the next draws are those after a "none" step."""
    tp.register_droppath_variant(monkeypatch, rate=0.6)
    after = {}
    for remat in ("none", "blocks"):
        torch.manual_seed(0)
        cfg = _cfg(remat, tp.DROPPATH_VARIANT, DROP_SIZE)
        state = create_train_state(cfg, device="cpu")
        gen = torch.Generator().manual_seed(7)
        set_generator(state.model, gen)
        batch = make_batch(np.random.default_rng(3), 2, (DROP_SIZE, DROP_SIZE), max_boxes=16)
        build_train_step(cfg, device="cpu")(state, batch)
        after[remat] = torch.rand(8, generator=gen)
    torch.testing.assert_close(after["blocks"], after["none"], rtol=0, atol=0)


def test_lean_step_counts(monkeypatch):
    """"blocks" with ASY_MIXER_BWD_RESIDUALS=0 (the lean step): no residual
    pack is asked for, every fused block's backward is the remat one, and
    the mixer forward runs once more per recomputed backbone block while the
    MLP forward does not."""
    monkeypatch.setenv("ASY_MIXER_BWD_RESIDUALS", "0")
    asked = []
    real = tb.mixer_block

    def spy(*a, return_residuals=False, **kw):
        asked.append(return_residuals)
        return real(*a, return_residuals=return_residuals, **kw)

    monkeypatch.setattr(tb, "mixer_block", spy)
    bwd = []
    real_bwd = tb.mixer_block_bwd
    monkeypatch.setattr(tb, "mixer_block_bwd",
                        lambda *a, **kw: (bwd.append(a[9] is None), real_bwd(*a, **kw))[1])
    calls = _counted(monkeypatch, ("mlp_block",))
    m, _, _, _ = _step("blocks")
    assert np.isfinite(m["loss"])
    assert asked == [False] * 18 and bwd == [True] * 10 and calls == {"mlp_block": 10}


def test_remat_blocks_matches_jax():
    """One train step under "blocks" in each package from the same state
    (JAX: nn.remat over each backbone ClusterBlock and the fusion modules,
    Pallas kernels in interpret mode)."""
    from asy_vrnet_tpu.train.train_step import build_train_step as j_build

    jcfg, tcfg = tp.train_configs("fixed", SIZE, use_pallas_cluster=True)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, train_remat="blocks"))
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, train_remat="blocks"))
    jm, j0, tx = tp.jax_train_setup(jcfg, tcfg, size=SIZE, seed=1)
    batch = make_batch(np.random.default_rng(0), 2, (SIZE, SIZE))
    j1, jm1 = jax.jit(j_build(jm, jcfg, tx))(j0, jax.tree.map(jnp.asarray, batch))
    t0 = tp.port_state_from_jax(tcfg, j0)
    fused = []
    hooks = [m.register_forward_pre_hook(lambda m, a: fused.append(m.fused_ok(a[0])))
             for m in t0.model.modules() if isinstance(m, ClusterBlock)]
    t1, tm1 = build_train_step(tcfg, device="cpu")(t0, batch)
    for h in hooks:
        h.remove()
    # the forward of the 10 fused blocks and the recompute of the 8 in the
    # backbone
    assert sum(fused) == 10 + 8
    tp.check_first_step(dict(tm1=tm1, jm1=jm1, j1=j1, t1=t1))
