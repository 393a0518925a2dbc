"""The z1 residual of the MLP half (`ASY_MLP_BWD_RESIDUALS=1`): K1 also
stores the pre-GELU z1 and K5 reads it instead of recomputing fc1.  The
port's plain twins against the JAX package's Pallas kernels in interpret
mode, on the CPU, from numpy inputs made from a seed.

f32: atol 1e-5 * max(1, max |ref|), rtol 1e-5 (the same arithmetic in
another order), as tests/test_torch_block_bwd.py.  bf16: z1 is rounded to
bf16 where `_mlp_block_kernel` rounds it (before GELU in the backward, not in
the forward), so the two packages' z1 agree to the last bf16 place (one ulp
where a reassociated f32 sum lands on the other side of a rounding
boundary); fed the same bf16 z1, the backward agrees to bf16 resolution, and
differs from the remat backward by more than that.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.ops import block_pallas as jb

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

from asy_vrnet_tpu_torch.ops import block as tb

# (B, H, W, C, hid): nano stage-0 and stage-2 widths, and an MLP ratio of 4
SHAPES = {"c16": (2, 32, 32, 16, 128), "c80": (2, 16, 16, 80, 320), "c32": (2, 16, 16, 32, 128)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def assert_close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5, err_msg=what)


def _args(shape, seed):
    b, h, w, c, hid = shape
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, g = n(b, h, w, c) * 2.0 + 0.5, n(b, h, w, c)
    w1, b1, w2, b2 = n(c, hid) * 0.2, n(hid) * 0.1, n(hid, c) * 0.2, n(c) * 0.1
    st = tb.gn1_stats(_t(x)).numpy()
    return x, g, st, w1, b1, w2, b2


def _jax_z1(x, st, w1, b1, w2, b2, dtype=jnp.float32):
    """JAX's K1 with its z1 residual: (out, z1 (B, H, W, hid))."""
    out, z = jb._mlp_block_pallas(jnp.asarray(x, dtype), jnp.asarray(st),
                                  *[jnp.asarray(a, dtype if a.ndim == 2 else jnp.float32)
                                    for a in (w1, b1, w2, b2)],
                                  interpret=True, residuals=True)
    return out, z.reshape(*x.shape[:3], w1.shape[1])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_z1_matches_jax_kernel(name):
    x, _, st, w1, b1, w2, b2 = _args(SHAPES[name], 1)
    jout, jz = _jax_z1(x, st, w1, b1, w2, b2)
    out, z1 = tb.mlp_block(*[_t(a) for a in (x, st, w1, b1, w2, b2)], return_z1=True)
    assert z1.shape == (*x.shape[:3], w1.shape[1]) and z1.dtype == torch.float32
    assert_close(z1, jz, "z1")
    assert_close(out, jout, "out")
    # the output is the one without the residual
    assert torch.equal(out, tb.mlp_block(*[_t(a) for a in (x, st, w1, b1, w2, b2)]))
    assert not any(tb.LAUNCHES.values())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_backward_z1_matches_jax_kernel(name):
    """K5's z1 twin fed JAX's z1 against `_mlp_bwd_pallas(..., z_res=...)`."""
    x, g, st, w1, b1, w2, b2 = _args(SHAPES[name], 2)
    b, h, w, c, hid = SHAPES[name]
    _, jz = _jax_z1(x, st, w1, b1, w2, b2)
    th = jb._mlp_rows(h, w, hid)
    z_res = jnp.asarray(jz).reshape(b, h // th, th * w, hid)
    jdxn, jdw1, jdb1, jdw2, jdb2, jsum = jb._mlp_bwd_pallas(
        *[jnp.asarray(a) for a in (x, g, st, w1, b1, w2)], interpret=True, z_res=z_res)
    got = tb.mlp_block_bwd(*[_t(a) for a in (x, g, st, w1, b1, w2)], _t(jz))
    want = (jdxn, np.sum(jdw1, 0), np.sum(jdb1, (0, 1)), np.sum(jdw2, 0),
            np.sum(jdb2, (0, 1)), np.asarray(jsum)[:, 0, :2])
    for what, a, w_ in zip(("dxn", "dw1", "db1", "dw2", "db2", "gn_sums"), got, want):
        assert_close(a, w_, what)


@pytest.mark.parametrize("name", ["c16", "c80"])
def test_autograd_with_z1_matches_jax_vjp(name, monkeypatch):
    """`fused_mlp_block_pre` with ASY_MLP_BWD_RESIDUALS=1 in both packages:
    every canonical gradient against jax.grad through the custom VJP, and
    the port's backward took the stored z1."""
    monkeypatch.setenv("ASY_MLP_BWD_RESIDUALS", "1")
    b, h, w, c, hid = SHAPES[name]
    rng = np.random.default_rng(3)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = n(b, h, w, c) * 2.0 + 0.5
    params = (n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, hid) * 0.2, n(hid) * 0.1, n(hid, c) * 0.2,
              n(c) * 0.1, n(c) * 0.05 + 1.0)
    gout = n(b, h, w, c)

    def jloss(x, *p):
        y = jb.fused_mlp_block_pre(x, jb.gn1_stats(x), *p)
        return jnp.sum(y * jnp.asarray(gout))

    want = jax.grad(jloss, argnums=tuple(range(8)))(*[jnp.asarray(a) for a in (x,) + params])
    seen = []
    real = tb.mlp_block_bwd
    monkeypatch.setattr(tb, "mlp_block_bwd",
                        lambda *a, **kw: (seen.append(a[6] is not None), real(*a, **kw))[1])
    ts = [_t(a).requires_grad_(True) for a in (x,) + params]
    y = tb.fused_mlp_block_pre(ts[0], tb.gn1_stats(ts[0]), *ts[1:])
    (y * _t(gout)).sum().backward()
    assert seen == [True]
    for i, (p, w_) in enumerate(zip(ts, want)):
        assert_close(p.grad, w_, f"grad of argument {i}")


def test_bf16_z1_rounding_is_jax():
    """bf16: the port's z1 is JAX's (the f32 z1 plus bias, rounded once to
    bf16), and the backward that reads it matches JAX's z1 backward to bf16
    resolution but not the remat backward (which takes GELU of the f32 z1)."""
    x, g, st, w1, b1, w2, b2 = _args(SHAPES["c16"], 4)
    b, h, w, c, hid = SHAPES["c16"]
    bf = torch.bfloat16
    _, jz = _jax_z1(x, st, w1, b1, w2, b2, jnp.bfloat16)
    jz = np.array(jz.astype(jnp.float32))
    xs, gs, w1s, w2s = (_t(a, bf) for a in (x, g, w1, w2))
    _, z1 = tb.mlp_block(xs, _t(st), w1s, _t(b1), w2s, _t(b2), return_z1=True)
    assert z1.dtype == bf
    zf = z1.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(jz), 1e-30))) - 7)
    assert (np.abs(zf - jz) <= ulp).all() and (zf == jz).mean() >= 0.999

    th = jb._mlp_rows(h, w, hid)
    jbwd = jb._mlp_bwd_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
                              jnp.asarray(st), jnp.asarray(w1, jnp.bfloat16), jnp.asarray(b1),
                              jnp.asarray(w2, jnp.bfloat16), interpret=True,
                              z_res=jnp.asarray(jz, jnp.bfloat16).reshape(b, h // th, th * w, hid))
    zin = torch.from_numpy(jz).to(bf)
    got = tb.mlp_block_bwd(xs, gs, _t(st), w1s, _t(b1), w2s, zin)
    remat = tb.mlp_block_bwd(xs, gs, _t(st), w1s, _t(b1), w2s)
    want = (np.asarray(jbwd[0].astype(jnp.float32)), np.sum(jbwd[1], 0), np.sum(jbwd[3], 0))
    for what, a, r, w_ in zip(("dxn", "dw1", "dw2"), (got[0], got[1], got[3]),
                              (remat[0], remat[1], remat[3]), want):
        a, r = a.float().numpy(), r.float().numpy()
        scale = float(np.abs(w_).max())
        err, off = np.abs(a - w_).max(), np.abs(r - w_).max()
        # within 2 bf16 ulps of the scale; the remat backward is further off
        assert err <= 2 * 2.0 ** (np.floor(np.log2(scale)) - 7), (what, err, scale)
        assert off > err, (what, off, err)
