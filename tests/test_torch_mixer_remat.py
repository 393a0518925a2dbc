"""The port's full-remat mixer backward (K6r, `ASY_MIXER_BWD_RESIDUALS=0`)
against the JAX package, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.  JAX
runs `_mixer_bwd_pallas(..., residuals=None)` (body `_mixer_bwd_kernel`) in
interpret mode; the port runs K6r's plain twin.  Everything is f32.
Tolerance: atol 1e-5 * max(1, max |ref|) per output, rtol 1e-5 (the same
arithmetic in another order), as tests/test_torch_block_bwd.py.  K6r's twin
against K6's twin fed K2's pack: the same function, which
tests/test_bwd_residuals.py pins to f32 rounding (atol and rtol 1e-5).

Shapes (B, H, W, C, heads, head_dim, fold): tests/test_bwd_residuals.py's
block (2 regions per TPU tile), a 4-region grouping at C = 32 and an
ungrouped 256-token region with nano's neck head width 24.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.ops import block_pallas as jb
from asy_vrnet_tpu.ops.cluster_pallas import _group_w

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

from asy_vrnet_tpu_torch.models import remat as rm
from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
from asy_vrnet_tpu_torch.ops import block as tb

SHAPES = {"c16_gw2": (2, 32, 32, 16, 4, 32, 2), "c32_gw4": (2, 32, 32, 32, 4, 32, 4),
          "c64_gw1": (2, 16, 16, 64, 4, 24, 1)}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_close(got, want, what, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=tol, err_msg=what)


def _canonical(shape, seed):
    b, h, w, c, heads, d, _ = shape
    inner = heads * d
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(b, h, w, c), n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, inner) * 0.2,
            n(inner) * 0.1, n(c, inner) * 0.2, n(inner) * 0.1, n(inner, c) * 0.2,
            n(c) * 0.1, n(c) * 0.05 + 1.0, np.float32(1.4), np.float32(-0.3))


def _folded(args):
    ops = tb._mixer_operands(*[_t(a) for a in args])
    x = _t(args[0])
    return (args[0], tb.gn1_stats(x).numpy(), *[o.numpy() for o in ops])


def _geo(shape):
    _, _, _, _, heads, _, fold = shape
    return dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)


NAMES = ("dxn", "dwf", "dbf", "dwv", "dbv", "dw2", "db2", "dalpha_dbeta", "gn_sums")


def test_shapes_cover_the_region_groupings():
    assert [_group_w(s[6], (s[1] // s[6]) * (s[2] // s[6])) for s in SHAPES.values()] == [2, 4, 1]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_remat_twin_matches_jax_kernel(name):
    """K6r's twin against `_mixer_bwd_pallas(..., residuals=None)`, every
    output (the weight partials summed over the batch as the VJP sums them)."""
    shape = SHAPES[name]
    _, _, _, _, heads, _, fold = shape
    x, st, wf, bf, wv, bv, w2, _b2, ab = _folded(_canonical(shape, 2))
    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    (jdxn, jdwf, jdbf, jdwv, jdbv, jdw2, jdb2, jdab) = jb._mixer_bwd_pallas(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(st),
        *[jnp.asarray(a) for a in (wf, bf, wv, bv, w2)], jnp.asarray(ab[0]),
        jnp.asarray(ab[1]), heads, fold, fold, 2, 2, interpret=True, residuals=None)
    got = tb.mixer_block_bwd(_t(x), _t(g), _t(st), *[_t(a) for a in (wf, bf, wv, bv, w2, ab)],
                             None, **_geo(shape))
    jdab = np.asarray(jdab)
    want = (jdxn, np.sum(jdwf, 0), np.sum(jdbf, (0, 1)), np.sum(jdwv, 0),
            np.sum(jdbv, (0, 1)), np.sum(jdw2, 0), np.sum(jdb2, (0, 1)),
            jdab[..., :2].sum((0, 1, 2)), jdab[..., 2:4].sum((1, 2)))
    for what, a, w in zip(NAMES, got, want):
        assert_close(a, w, what)
    assert not any(tb.LAUNCHES.values())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_remat_twin_matches_residual_twin(name):
    """K6r's twin against K6's twin fed the K2 twin's residual pack: the same
    function (f32: the pack stores the f32 values the remat rebuilds); the
    rebuilt assignment is the forward's."""
    shape = SHAPES[name]
    x, st, wf, bf, wv, bv, w2, b2, ab = (_t(a) for a in _folded(_canonical(shape, 4)))
    g = _t(np.random.default_rng(5).standard_normal(x.shape))
    _, _, pack = tb.mixer_block_plain(x, st, wf, bf, wv, bv, w2, b2, ab,
                                      return_residuals=True, **_geo(shape))
    want = tb.mixer_block_bwd_plain(x, g, st, wf, bf, wv, bv, w2, ab, pack, **_geo(shape))
    *got, assign = tb.mixer_block_bwd(x, g, st, wf, bf, wv, bv, w2, ab, None,
                                      return_assign=True, **_geo(shape))
    assert torch.equal(assign, pack[1])
    for what, a, w in zip(NAMES, got, want):
        assert_close(a, w, what)


def _chained(shape, seed):
    _, _, _, c, _, _, _ = shape
    margs = _canonical(shape, seed)
    rng = np.random.default_rng(seed + 1)
    hid = 4 * c
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    largs = (n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, hid) * 0.2, n(hid) * 0.1, n(hid, c) * 0.2,
             n(c) * 0.1, n(c) * 0.05 + 1.0)
    return margs, largs, n(*shape[:4])


def _port_grads(shape, margs, largs, gout):
    geo = _geo(shape)
    params = [_t(a).requires_grad_(True) for a in margs + largs]
    y, st = tb.fused_mixer_block_stats(*params[:12], *geo.values())
    y = tb.fused_mlp_block_pre(y, st, *params[12:])
    (y * _t(gout)).sum().backward()
    return [p.grad for p in params]


@pytest.mark.parametrize("name", ["c16_gw2", "c64_gw1"])
def test_autograd_without_residuals_matches_jax_vjp(name, monkeypatch):
    """`fused_mixer_block_stats` chained into `fused_mlp_block_pre` under
    autograd with ASY_MIXER_BWD_RESIDUALS=0 in both packages (JAX reads it
    while tracing, the port in the autograd forward): every canonical
    gradient against jax.grad through the custom VJPs."""
    monkeypatch.setenv("ASY_MIXER_BWD_RESIDUALS", "0")
    shape = SHAPES[name]
    _, _, _, _, heads, _, fold = shape
    margs, largs, gout = _chained(shape, 6)

    def jloss(*a):
        y, st = jb.fused_mixer_block_stats(*a[:12], heads, fold, fold, 2, 2, 1)
        y = jb.fused_mlp_block_pre(y, st, *a[12:])
        return jnp.sum(y * jnp.asarray(gout))

    want = jax.grad(jloss, argnums=tuple(range(19)))(*[jnp.asarray(a) for a in margs + largs])
    calls = []
    real = tb.mixer_block_bwd
    monkeypatch.setattr(tb, "mixer_block_bwd",
                        lambda *a, **kw: (calls.append(a[9] is None), real(*a, **kw))[1])
    for i, (gr, w) in enumerate(zip(_port_grads(shape, margs, largs, gout), want)):
        assert_close(gr, w, f"grad of argument {i}")
    assert calls == [True]


def test_switch_is_read_in_the_forward(monkeypatch):
    """The decision is the forward's: flipping the variable between forward
    and backward changes nothing (K6r runs when the forward kept no pack,
    K6 when it did), as JAX fixes it when it traces the forward."""
    shape = SHAPES["c16_gw2"]
    margs, largs, gout = _chained(shape, 8)
    geo = _geo(shape)
    grads, calls = {}, []
    real = tb.mixer_block_bwd
    monkeypatch.setattr(tb, "mixer_block_bwd",
                        lambda *a, **kw: (calls.append(a[9] is None), real(*a, **kw))[1])
    for fwd, bwd in (("0", "1"), ("1", "0")):
        monkeypatch.setenv("ASY_MIXER_BWD_RESIDUALS", fwd)
        params = [_t(a).requires_grad_(True) for a in margs + largs]
        y, st = tb.fused_mixer_block_stats(*params[:12], *geo.values())
        y = tb.fused_mlp_block_pre(y, st, *params[12:])
        monkeypatch.setenv("ASY_MIXER_BWD_RESIDUALS", bwd)
        (y * _t(gout)).sum().backward()
        grads[fwd] = [p.grad for p in params]
    assert calls == [True, False]
    for i, (a, b) in enumerate(zip(grads["0"], grads["1"])):
        assert_close(a, b, f"grad of argument {i}")


def test_recompute_takes_the_forward_switches(monkeypatch):
    """A ClusterBlock rematerialised as under train_remat="blocks": the
    switches change between its forward and its backward, and the recompute
    still saves what the forward saved (checkpoint would refuse otherwise),
    with the gradients of an unrematerialised block."""
    torch.manual_seed(0)
    blk = ClusterBlock(32, mlp_ratio=4.0, fold_h=2, fold_w=2, heads=4, head_dim=32)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(torch.randn(p.shape) * 0.1)
    x0 = torch.randn(2, 32, 32, 32).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    gout = torch.randn(x0.shape)
    grads = {}
    for remat in (False, True):
        monkeypatch.setenv("ASY_MIXER_BWD_RESIDUALS", "0")
        monkeypatch.setenv("ASY_MLP_BWD_RESIDUALS", "1")
        x = x0.clone().requires_grad_(True)
        blk.zero_grad()
        y = rm.span(lambda t: rm.stack([blk], t), [blk], x) if remat else blk(x)
        monkeypatch.setenv("ASY_MIXER_BWD_RESIDUALS", "1")
        monkeypatch.setenv("ASY_MLP_BWD_RESIDUALS", "0")
        (y * gout).sum().backward()
        grads[remat] = [x.grad] + [p.grad.clone() for p in blk.parameters()]
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
