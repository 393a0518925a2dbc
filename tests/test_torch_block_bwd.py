"""The port's fused ClusterBlock backward (K2's residual pack, K5, K6 and the
two autograd Functions) against the JAX package, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.  JAX
runs its Pallas kernels in interpret mode (as tests/test_block_pallas.py and
tests/test_bwd_residuals.py do); the port runs the kernels' plain twins.
Everything is f32.  Tolerance: atol 1e-5 * max(1, max |ref|) per output,
rtol 1e-5 (the same arithmetic in another order; measured: at most 1e-6 of
each output's scale for the kernels' twins, 2.5e-6 through the autograd
Functions).  Assignments must agree exactly.

Shapes: (2, 32, 32, 16) with 4 heads x 32, fold 2 (the JAX tests' block) and
(2, 32, 32, 80) with 8 heads x 32, fold 2 (nano stage 2's widths, 256-token
regions).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.models.cluster_block import ClusterBlock as JClusterBlock
from asy_vrnet_tpu.ops import block_pallas as jb
from asy_vrnet_tpu.ops.cluster_pallas import _group_w

from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
from asy_vrnet_tpu_torch.ops import block as tb
from asy_vrnet_tpu_torch.utils.weights import flax_from_state_dict, state_dict_from_flax

# (B, H, W, C, heads, head_dim, fold)
SHAPES = {"c16": (2, 32, 32, 16, 4, 32, 2), "c80": (2, 32, 32, 80, 8, 32, 2)}
M = 4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5, err_msg=what)


def _canonical(shape, seed):
    """x and the canonical mixer params, with non-trivial GN affine,
    LayerScale, alpha and beta."""
    b, h, w, c, heads, d, _ = shape
    inner = heads * d
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(b, h, w, c), n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, inner) * 0.2,
            n(inner) * 0.1, n(c, inner) * 0.2, n(inner) * 0.1, n(inner, c) * 0.2,
            n(c) * 0.1, n(c) * 0.05 + 1.0, np.float32(1.4), np.float32(-0.3))


def _folded(args):
    """(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta) as numpy, folded the
    way both packages fold."""
    ops = tb._mixer_operands(*[_t(a) for a in args])
    x = _t(args[0])
    return (args[0], tb.gn1_stats(x).numpy(), *[o.numpy() for o in ops])


def _jax_pack_to_port(pack, shape):
    """JAX's per-tile residuals (B, tiles, rows, cols) -> the port's layout:
    cbest/argf (B, H, W, heads), c_rep/oc (B, R, heads*M, head_dim)."""
    b, h, w, _, heads, d, fold = shape
    rh, rw = h // fold, w // fold
    gw = _group_w(fold, rh * rw)
    fwg = fold // gw
    cbest, argf, crep, oc = (np.asarray(p, np.float32) for p in pack)

    def tokens(t):       # (b, fold*fwg, gw*heads, rh*gw*rw), region diagonal
        t = t.reshape(b, fold, fwg, gw, heads, rh, gw, rw)
        t = np.stack([t[:, :, :, g, :, :, g, :] for g in range(gw)], 3)
        return t.transpose(0, 1, 5, 2, 3, 6, 4).reshape(b, h, w, heads)

    def centers(t):      # (b, fold*fwg, (m, gw, heads), heads*d), head diagonal
        t = t.reshape(b, fold, fwg, M, gw, heads, heads, d)
        t = np.stack([t[:, :, :, :, :, k, k, :] for k in range(heads)], 5)
        return t.transpose(0, 1, 2, 4, 5, 3, 6).reshape(b, fold * fold, heads * M, d)

    return tokens(cbest), tokens(argf), centers(crep), centers(oc)


def _jax_forward_pack(folded, shape):
    x, st, wf, bf, wv, bv, w2, b2, ab = folded
    _, _, _, _, heads, _, fold = shape
    out, _, pack = jb._mixer_block_pallas(
        jnp.asarray(x), jnp.asarray(st), *[jnp.asarray(a) for a in (wf, bf, wv, bv, w2, b2)],
        jnp.asarray(ab[0]), jnp.asarray(ab[1]), heads, fold, fold, 2, 2, interpret=True,
        residuals=True)
    return np.asarray(out), _jax_pack_to_port(pack, shape), pack


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_residual_pack_matches_jax_kernel(name):
    shape = SHAPES[name]
    _, _, _, _, heads, _, fold = shape
    folded = _folded(_canonical(shape, 1))
    jout, (jcb, jarg, jcrep, joc), _ = _jax_forward_pack(folded, shape)
    out, _, pack = tb.mixer_block(*[_t(a) for a in folded], heads=heads, fold_h=fold,
                                  fold_w=fold, proposal_h=2, proposal_w=2,
                                  return_residuals=True)
    cbest, argf, crep, oc = pack
    assert argf.dtype == torch.int8 and cbest.shape == (*shape[:3], heads)
    assert crep.shape == oc.shape == (shape[0], fold * fold, heads * M, shape[5])
    np.testing.assert_array_equal(argf.numpy(), jarg.astype(np.int8))
    assert_close(cbest, jcb, "cbest")
    assert_close(crep, jcrep, "c_rep")
    assert_close(oc, joc, "oc")
    assert_close(out, jout, "out")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_mixer_bwd_twin_matches_jax_kernel(name):
    """K6's twin fed JAX's own residual pack (mapped to the port's layout)
    against `_mixer_bwd_pallas(..., residuals=pack)`."""
    shape = SHAPES[name]
    b, _, _, c, heads, _, fold = shape
    folded = _folded(_canonical(shape, 2))
    x, st, wf, bf, wv, bv, w2, b2, ab = folded
    _, port_pack, jpack = _jax_forward_pack(folded, shape)
    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    (jdxn, jdwf, jdbf, jdwv, jdbv, jdw2, jdb2, jdab) = jb._mixer_bwd_pallas(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(st),
        *[jnp.asarray(a) for a in (wf, bf, wv, bv, w2)], jnp.asarray(ab[0]),
        jnp.asarray(ab[1]), heads, fold, fold, 2, 2, interpret=True, residuals=jpack)
    pack = (_t(port_pack[0]), torch.from_numpy(port_pack[1].astype(np.int8)),
            _t(port_pack[2]), _t(port_pack[3]))
    got = tb.mixer_block_bwd(_t(x), _t(g), _t(st), *[_t(a) for a in (wf, bf, wv, bv, w2, ab)],
                             pack, heads=heads, fold_h=fold, fold_w=fold, proposal_h=2,
                             proposal_w=2)
    jdab = np.asarray(jdab)
    want = (jdxn, np.sum(jdwf, 0), np.sum(jdbf, (0, 1)), np.sum(jdwv, 0),
            np.sum(jdbv, (0, 1)), np.sum(jdw2, 0), np.sum(jdb2, (0, 1)),
            jdab[..., :2].sum((0, 1, 2)), jdab[..., 2:4].sum((1, 2)))
    names = ("dxn", "dwf", "dbf", "dwv", "dbv", "dw2", "db2", "dalpha_dbeta", "gn_sums")
    for what, a, w in zip(names, got, want):
        assert_close(a, w, what)
    assert not any(tb.LAUNCHES.values())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_mlp_bwd_twin_matches_jax_kernel(name):
    b, h, w, c = SHAPES[name][:4]
    hid = 4 * c
    rng = np.random.default_rng(4)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, g = n(b, h, w, c) * 2.0 + 0.5, n(b, h, w, c)
    w1, b1, w2 = n(c, hid) * 0.2, n(hid) * 0.1, n(hid, c) * 0.2
    st = tb.gn1_stats(_t(x)).numpy()
    jdxn, jdw1, jdb1, jdw2, jdb2, jsum = jb._mlp_bwd_pallas(
        *[jnp.asarray(a) for a in (x, g, st, w1, b1, w2)], interpret=True)
    got = tb.mlp_block_bwd(*[_t(a) for a in (x, g, st, w1, b1, w2)])
    want = (jdxn, np.sum(jdw1, 0), np.sum(jdb1, (0, 1)), np.sum(jdw2, 0),
            np.sum(jdb2, (0, 1)), np.asarray(jsum)[:, 0, :2])
    for what, a, w_ in zip(("dxn", "dw1", "db1", "dw2", "db2", "gn_sums"), got, want):
        assert_close(a, w_, what)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_autograd_functions_match_jax_vjp(name):
    """Both halves chained as ClusterBlock chains them, every canonical
    gradient (x, both GN affines, the 1x1 weights and biases, both
    LayerScales, alpha, beta) against jax.grad through the custom VJPs."""
    shape = SHAPES[name]
    _, _, _, c, heads, _, fold = shape
    margs = _canonical(shape, 5)
    rng = np.random.default_rng(6)
    hid = 4 * c
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    largs = (n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, hid) * 0.2, n(hid) * 0.1, n(hid, c) * 0.2,
             n(c) * 0.1, n(c) * 0.05 + 1.0)
    gout = n(*shape[:4])

    def jloss(*a):
        y, st = jb.fused_mixer_block_stats(*a[:12], heads, fold, fold, 2, 2, 1)
        y = jb.fused_mlp_block_pre(y, st, *a[12:])
        return jnp.sum(y * jnp.asarray(gout))

    want = jax.grad(jloss, argnums=tuple(range(19)))(*[jnp.asarray(a) for a in margs + largs])
    params = [_t(a).requires_grad_(True) for a in margs + largs]
    y, st = tb.fused_mixer_block_stats(*params[:12], heads, fold, fold, 2, 2)
    assert not st.requires_grad
    y = tb.fused_mlp_block_pre(y, st, *params[12:])
    (y * _t(gout)).sum().backward()
    for i, (p, w) in enumerate(zip(params, want)):
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert_close(p.grad, w, f"grad of argument {i}")
    assert not any(tb.LAUNCHES.values())


def _jax_block(shape):
    _, _, _, c, heads, d, fold = shape
    return JClusterBlock(dim=c, mlp_ratio=4.0, heads=heads, head_dim=d, fold_h=fold,
                         fold_w=fold, use_pallas=True, dtype=jnp.float32)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_train_mode_cluster_block_matches_jax(name):
    """ClusterBlock(fused=True) in train mode: output, input gradient and
    every parameter gradient against JAX ClusterBlock(use_pallas=True) under
    jax.grad, and against the port's own module path (plain autograd; the
    same function in another formulation: atol 1e-4 * scale, rtol 1e-4)."""
    shape = SHAPES[name]
    b, h, w, c, heads, d, fold = shape
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    jm = _jax_block(shape)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda v: np.asarray(v) + rng.normal(0, 0.05, v.shape).astype(
        np.float32), params)

    def jloss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, train=True) * jnp.asarray(g))

    jout = jm.apply({"params": params}, jnp.asarray(x), train=True)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    results = {}
    for fused in (True, False):
        blk = ClusterBlock(c, mlp_ratio=4.0, heads=heads, head_dim=d, fold_h=fold,
                           fold_w=fold, fused=fused)
        holder = torch.nn.Module()          # the bridge names the block "blk"
        holder.blk = blk
        holder.load_state_dict(state_dict_from_flax({"blk": params}, {}), strict=True)
        blk.train()
        xt = _t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        xt.requires_grad_(True)
        assert blk.fused_ok(xt) == fused
        y = blk(xt)
        (y * _t(g).permute(0, 3, 1, 2)).sum().backward()
        grads = {k: p.grad for k, p in holder.named_parameters()}
        results[fused] = (y.detach().permute(0, 2, 3, 1), xt.grad.permute(0, 2, 3, 1),
                          flax_from_state_dict(grads, {"blk": params})["blk"])
    out, gx, gp = results[True]
    assert_close(out, jout, "out")
    assert_close(gx, jgx, "dx")
    want = jax.tree_util.tree_leaves_with_path(jgp)
    got = jax.tree_util.tree_leaves(gp)
    assert len(want) == len(got) == len(list(blk.parameters()))
    for (path, wv), gv in zip(want, got):
        assert_close(gv, wv, jax.tree_util.keystr(path))
    mout, mgx, mgp = results[False]
    for what, a, ref in (("out", out, mout), ("dx", gx, mgx)):
        np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, ref.abs().max().item()), err_msg=what)
    for a, ref in zip(got, jax.tree_util.tree_leaves(mgp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_fused_eval_forward_writes_no_residuals(monkeypatch):
    """Without autograd the fused halves take the eval path: no residual
    pack is asked for."""
    shape = SHAPES["c16"]
    _, _, _, _, heads, _, fold = shape
    asked = []
    real = tb.mixer_block

    def spy(*a, return_residuals=False, **kw):
        asked.append(return_residuals)
        return real(*a, return_residuals=return_residuals, **kw)

    monkeypatch.setattr(tb, "mixer_block", spy)
    args = [_t(a) for a in _canonical(shape, 8)]
    with torch.no_grad():
        tb.fused_mixer_block_stats(*[a.requires_grad_(True) for a in args], heads, fold,
                                   fold, 2, 2)
    tb.fused_mixer_block_stats(*[a.detach() for a in args], heads, fold, fold, 2, 2)
    tb.fused_mixer_block_stats(*[a.detach().requires_grad_(True) for a in args], heads,
                               fold, fold, 2, 2)
    assert asked == [False, False, True]
