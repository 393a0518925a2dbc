"""K8 closure: the JAX package's lane-folded block kernels against the port's
kernels' twins on the unfolded layout, on the CPU.

Lane folding (`lane_fold_choice`, `block_pallas.py:236`) packs s = 128/C
consecutive W tokens into the 128 TPU lanes, (B, H, W, C) -> (B, H, W/s,
s*C); it is a TPU layout and the port has no folded kernels: K2, K1, K6, K6r
and K5 take the unfolded layout.  At nano's stage-0 and stage-1 widths
(C = 16 and 32, 4 heads x 32), where the fold applies, JAX's
`fused_mixer_block_stats(..., lane_fold=s)` (K2f forward, K6f backward with
and without the residual pack) chained into `fused_mlp_block_pre(...,
lane_fold=s)` (K1/K5 on block-diagonal weights) runs in interpret mode and
is held against the port's `fused_mixer_block_stats` and
`fused_mlp_block_pre` (the twins of K2, K1, K6 or K6r, and K5): forward
outputs, the output GN stats and every canonical gradient.  Tolerances are
tests/test_lane_fold.py's, which holds the folded kernels against the
unfolded ones in JAX: the folded token order reassociates the f32 sums, so
forward atol 1e-5 * max(1, max |ref|), rtol 1e-5, gradients 2e-4 of the
same.

The whole-model parity tests (tests/test_torch_model*.py,
test_torch_train_fused.py) do not reach K2f/K6f: `stage_lane_fold`
(`asy_vrnet_tpu/models/vr_coc.py:311`) gives 1 at coc_dryrun 64^2 and 128^2
(the folded region token count is not a multiple of 128), so this file is
the only place the folded kernels meet the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.ops import block_pallas as jb

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

from asy_vrnet_tpu_torch.ops import block as tb

# (B, H, W, C), fold, lane fold s; 4 heads x 32, MLP ratio 8 (nano stages 0-1)
CASES = {"c16": ((2, 64, 64, 16), 4, 8), "c32": ((2, 64, 64, 32), 4, 4)}
HEADS, HEAD_DIM, PROP = 4, 32, 2


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_close(got, want, what, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=tol, err_msg=what)


def _fold(x, s):
    b, h, w, c = x.shape
    return x.reshape(b, h, w // s, s * c)


def _args(case, seed):
    (b, h, w, c), _, _ = CASES[case]
    inner, hid = HEADS * HEAD_DIM, 8 * c
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mixer = (n(b, h, w, c) * 0.5, n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, inner) * 0.2,
             n(inner) * 0.1, n(c, inner) * 0.2, n(inner) * 0.1, n(inner, c) * 0.2,
             n(c) * 0.1, n(c) * 0.1 + 0.5, np.float32(1.3), np.float32(-0.2))
    mlp = (n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, hid) * 0.2, n(hid) * 0.1, n(hid, c) * 0.2,
           n(c) * 0.1, n(c) * 0.1 + 0.5)
    return mixer, mlp, n(b, h, w, c)


def _jax_block(case, folded):
    """x, *params -> (out, mixer out, its GN stats), unfolded; with `folded`
    the two halves run lane-folded."""
    _, fold, s = CASES[case]
    lf = s if folded else 1

    def fn(x, *p):
        xx = _fold(x, s) if folded else x
        y, st = jb.fused_mixer_block_stats(xx, *p[:11], HEADS, fold, fold, PROP, PROP, lf)
        out = jb.fused_mlp_block_pre(y, st, *p[11:], lf)
        return out.reshape(x.shape), y.reshape(x.shape), st
    return fn


def _port_block(case, args, grad):
    _, fold, _ = CASES[case]
    ts = [_t(a).requires_grad_(grad) for a in args]
    y, st = tb.fused_mixer_block_stats(*ts[:12], HEADS, fold, fold, PROP, PROP)
    return ts, tb.fused_mlp_block_pre(y, st, *ts[12:]), y, st


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_fold_applies(case):
    shape, fold, s = CASES[case]
    assert jb.lane_fold_choice(shape, fold_h=fold, fold_w=fold, inner=HEADS * HEAD_DIM) == s


@pytest.mark.parametrize("case", sorted(CASES))
def test_folded_forward_matches_port(case):
    """K2f and K1 (lane-folded) against the K2 and K1 twins: the block's
    output, the mixer half's output and its GN stats."""
    mixer, mlp, _ = _args(case, 1)
    args = mixer + mlp
    jout, jy, jst = _jax_block(case, folded=True)(*[jnp.asarray(a) for a in args])
    _, out, y, st = _port_block(case, args, grad=False)
    assert_close(y, jy, "mixer out", 1e-5)
    assert_close(st, jst, "mixer out GN stats", 1e-5)
    assert_close(out, jout, "block out", 1e-5)


@pytest.mark.parametrize("residuals", ["pack", "remat"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_folded_grads_match_port(case, residuals, monkeypatch):
    """Every canonical gradient of the chained halves: JAX's K6f (with the
    pack, or its full-remat body under ASY_MIXER_BWD_RESIDUALS=0) and K5 on
    the folded layout against the port's K6 or K6r twin and K5 twin."""
    monkeypatch.setenv("ASY_MIXER_BWD_RESIDUALS", "1" if residuals == "pack" else "0")
    mixer, mlp, gout = _args(case, 2)
    args = mixer + mlp
    fwd = _jax_block(case, folded=True)

    def jloss(*a):
        return jnp.sum(fwd(*a)[0] * jnp.asarray(gout))

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(*[jnp.asarray(a) for a in args])
    calls = []
    real = tb.mixer_block_bwd
    monkeypatch.setattr(tb, "mixer_block_bwd",
                        lambda *a, **kw: (calls.append(a[9] is None), real(*a, **kw))[1])
    ts, out, _, _ = _port_block(case, args, grad=True)
    (out * _t(gout)).sum().backward()
    assert calls == [residuals == "remat"]
    for i, (p, w) in enumerate(zip(ts, want)):
        assert_close(p.grad, w, f"grad of argument {i}", 2e-4)
