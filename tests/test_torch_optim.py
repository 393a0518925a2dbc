"""The port's optimiser, schedules and EMA against the JAX package.

Tolerances: parameters after 3 optimiser steps atol 1e-6 (torch.optim's SGD
and Adam against the optax chain of `make_optimizer`, f32, the same updates
in another association); schedules equal to 1e-12 relative (pure Python on
both sides); EMA atol 1e-6 (a few f32 ulps at |v| <= 4: the decay is
computed in f64 here and in f32 there, and d*e + (1-d)*n rounds in another
order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.config import OptimConfig as JOptimConfig
from asy_vrnet_tpu.train import optim as jopt

from asy_vrnet_tpu_torch.config import OptimConfig
from asy_vrnet_tpu_torch.train import optim as topt

# a small tree with mixed ndim; the flax leaf shapes and the port's differ
# where the bridge reshapes: sim_alpha () -> (1,), ShuffleAttention gates
# (C,) -> (1,C,1,1); both are decay-free on both sides
FLAX_SHAPES = {
    "conv": {"kernel": (3, 3, 4, 6), "bias": (6,)},
    "eca": {"conv_w": (1, 1, 3)},
    "mixer": {"sim_alpha": (), "sim_beta": ()},
    "norm": {"scale": (6,)},
    "sa": {"cweight": (5,), "sbias": (5,)},
}
PORT_SHAPES = {"sim_alpha": (1,), "sim_beta": (1,), "cweight": (1, 5, 1, 1),
               "sbias": (1, 5, 1, 1)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    return {m: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in FLAX_SHAPES.items()}


def _port_named(tree):
    return [(f"{m}.{k}", torch.from_numpy(v.reshape(PORT_SHAPES.get(k, v.shape)).copy())
             .requires_grad_(True)) for m, leaves in tree.items() for k, v in leaves.items()]


@pytest.mark.parametrize("kind", ["sgd", "sgd_plain_momentum", "adam"])
def test_three_steps_match_optax(kind):
    kw = dict(optimizer="adam" if kind == "adam" else "sgd",
              nesterov=kind != "sgd_plain_momentum", weight_decay=5e-2)
    params = _trees(0)
    grads = [_trees(10 + i) for i in range(3)]
    lrs = [1e-2, 2e-2, 5e-3]

    tx = jopt.make_optimizer(JOptimConfig(**kw), params)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    @jax.jit
    def jstep(p, s, g):
        import optax
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    named = _port_named(params)
    opt = topt.make_optimizer(OptimConfig(**kw), named)
    decayed = {id(p) for p in opt.param_groups[0]["params"]}
    assert {n for n, p in named if id(p) in decayed} == {"conv.kernel", "eca.conv_w"}
    for lr, g in zip(lrs, grads):
        opt_state = jopt.set_learning_rate(opt_state, lr)
        jparams, opt_state = jstep(jparams, opt_state, jax.tree.map(jnp.asarray, g))
        topt.set_learning_rate(opt, lr)
        assert topt.get_learning_rate(opt) == lr
        for (name, p), (_, gp) in zip(named, _port_named(g)):
            p.grad = gp.detach()
        opt.step()
    for name, p in named:
        m, k = name.split(".")
        np.testing.assert_allclose(p.detach().numpy().reshape(FLAX_SHAPES[m][k]),
                                   np.asarray(jparams[m][k]), atol=1e-6, err_msg=name)


def test_a_parameter_without_gradient_keeps_value_and_momentum():
    """What `freeze_backbone` relies on: no gradient -> no update, no weight
    decay, optimiser state untouched."""
    named = _port_named(_trees(1))
    opt = topt.make_optimizer(OptimConfig(weight_decay=0.1), named)
    topt.set_learning_rate(opt, 0.1)
    for _, p in named:
        p.grad = torch.ones_like(p)
    opt.step()
    frozen = named[0][1]
    before = frozen.detach().clone()
    buf = opt.state[frozen]["momentum_buffer"].clone()
    frozen.grad = None
    opt.step()
    assert torch.equal(frozen.detach(), before)
    assert torch.equal(opt.state[frozen]["momentum_buffer"], buf)
    assert not torch.equal(named[1][1].detach(), _port_named(_trees(1))[1][1].detach())


@pytest.mark.parametrize("name,args", [
    ("yolox_warm_cos_lr", (1e-2, 1e-4, 100)),
    ("yolox_warm_cos_lr", (5e-2, 5e-4, 30, 0.1, 0.2, 0.1)),
    ("step_lr", (1e-2, 1e-4, 100, 10)),
])
def test_schedules_equal_jax_at_20_points(name, args):
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for it in np.linspace(0, args[2], 20):
        assert tf(float(it)) == pytest.approx(jf(float(it)), rel=1e-12)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_adaptive_lr_and_make_lr_schedule_equal_jax(optimizer):
    for i, bs in enumerate(np.linspace(1, 512, 20).astype(int)):
        kw = dict(optimizer=optimizer, init_lr=1e-2 * (1 + i % 3),
                  lr_decay_type="cos" if i % 2 else "step")
        assert topt.adaptive_lr(OptimConfig(**kw), int(bs)) == \
            jopt.adaptive_lr(JOptimConfig(**kw), int(bs))
        jf = jopt.make_lr_schedule(JOptimConfig(**kw), int(bs), 50)
        tf = topt.make_lr_schedule(OptimConfig(**kw), int(bs), 50)
        assert tf(float(i)) == pytest.approx(jf(float(i)), rel=1e-12)


def test_ema_after_three_updates_matches_jax():
    ema = _trees(2)
    jema = jax.tree.map(jnp.asarray, ema)
    tema = {n: p.detach().clone() for n, p in _port_named(ema)}
    tema["bn.num_batches_tracked"] = torch.tensor(0)
    for t in (1.0, 2.0, 3.0):
        new = _trees(20 + int(t))
        d = jopt.ema_decay_schedule(jnp.float32(t), 0.9, 2.0)
        jema = jax.jit(jopt.ema_update)(jema, jax.tree.map(jnp.asarray, new), d)
        td = topt.ema_decay_schedule(t, 0.9, 2.0)
        assert td == pytest.approx(float(d), rel=1e-6)
        tnew = {n: p.detach() for n, p in _port_named(new)}
        tnew["bn.num_batches_tracked"] = torch.tensor(int(t))
        topt.ema_update(tema, tnew, td)
    assert tema.pop("bn.num_batches_tracked").item() == 3       # integers are copied
    for name, v in tema.items():
        m, k = name.split(".")
        np.testing.assert_allclose(v.numpy().reshape(FLAX_SHAPES[m][k]),
                                   np.asarray(jema[m][k]), atol=1e-6, err_msg=name)
