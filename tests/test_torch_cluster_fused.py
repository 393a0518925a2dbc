"""The port's stand-alone cluster mix (ops/cluster_fused.py: the twins of K7
and K7b, their autograd Function and the route a ClusterBlock takes to
them) and its plain bf16 `cluster_mix` against the JAX package, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.  JAX
runs its Pallas kernels in interpret mode (as tests/test_cluster_pallas.py
does); the port runs the kernels' plain twins.

Tolerances:
  f32: atol 1e-5 * max(1, max |ref|) per output, rtol 0: the same
    arithmetic in another order (measured: at most 1e-6 of each scale);
    assignments 100% equal.
  bf16 twins against the bf16 Pallas kernels: both round where the TPU
    kernel rounds but sum in another order, so a rounding can land on the
    other side and a near-tied assignment flip: agreement >= 99.9%, mean
    |diff| <= 1% of max |ref|.
  bf16 `cluster_mix` (f32 alpha, beta) against JAX's: the same bf16 steps
    op by op, then f32: max |diff| <= 1e-6 * max(1, max |ref|) (measured
    1.2e-7), assignments 100% equal.

The kernels' assignments are not outputs of the Pallas kernels; each test
reads them off the output: a token's mixed vector is its sim times its
winner's mixed center, so it points along that center (`_assignment`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.ops import cluster_pallas as jcp
from asy_vrnet_tpu.ops.cluster import cluster_mix as j_cluster_mix

from asy_vrnet_tpu_torch.models import cluster_block as tcb
from asy_vrnet_tpu_torch.ops import block as tb
from asy_vrnet_tpu_torch.ops import cluster_fused as cf
from asy_vrnet_tpu_torch.ops.cluster import _fold_tokens, _unfold_tokens, cluster_mix

ALPHA, BETA = 1.3, -0.2

# (B, H, W, heads, head_dim, fold, proposals): whole-map regions (gw 1), two
# regions side by side per program (gw 2), coc_tiny2's stage 0 at 128^2 (4x4
# proposals over 16-token regions, 8 regions per program: gw 8), overlapping
# adaptive windows (3x3 proposals over 4x4 regions)
CASES = {
    "gw1": (2, 16, 16, 4, 8, 1, 2),
    "gw2": (2, 32, 32, 4, 16, 2, 2),
    "prop4x4": (1, 32, 32, 4, 24, 8, 4),
    "overlap": (2, 12, 12, 2, 16, 3, 3),
}


def _geo(case):
    _, _, _, heads, _, fold, prop = case
    return dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=prop, proposal_w=prop)


def _inputs(case, seed, n=2):
    b, h, w, heads, d, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, w, heads * d)).astype(np.float32) for _ in range(n)]


def _ab():
    return torch.tensor([ALPHA, BETA])


def assert_close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=what)


def _mixed_centers(feat, value, geo):
    """The twin's mixed centers (B, heads, R, M, D), f32."""
    p = cf._remat(feat, value, _ab(), **geo)
    agg = torch.einsum("bhrmn,bhrnd->bhrmd", tb._round(p["sim"], feat.dtype), p["vf"])
    return (agg + p["vc"]) / (p["counts"] + 1.0)


def _assignment(out, centers, geo):
    """(B, H, W, heads) proposal whose center each token's output points along."""
    o, hw = _fold_tokens(torch.tensor(np.asarray(out, np.float32)), geo["heads"],
                         geo["fold_h"], geo["fold_w"])
    unit = lambda t: t / t.norm(dim=-1, keepdim=True).clamp_min(1e-30)  # noqa: E731
    arg = torch.einsum("bhrnd,bhrmd->bhrnm", unit(o), unit(centers)).argmax(-1)
    return _unfold_tokens(arg[..., None], hw, geo["fold_h"], geo["fold_w"]).to(torch.int8)


def _jax_fwd(feat, value, geo, dtype=jnp.float32):
    return np.asarray(jcp._cluster_nhwc_pallas(
        jnp.asarray(feat, dtype), jnp.asarray(value, dtype), jnp.float32(ALPHA),
        jnp.float32(BETA), interpret=True, **geo)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_twin_matches_pallas_kernel(name):
    case, geo = CASES[name], _geo(CASES[name])
    assert jcp.pallas_supported(case[:3] + (case[3] * case[4],), **geo)
    assert tb.pallas_supported(case[:3] + (case[3] * case[4],), **geo)
    feat, value = _inputs(case, 1)
    ref = _jax_fwd(feat, value, geo)
    ft, vt = torch.from_numpy(feat), torch.from_numpy(value)
    out, assign = cf.cluster_mix_fused_plain(ft, vt, _ab(), return_assign=True, **geo)
    assert out.dtype == torch.float32 and assign.dtype == torch.int8
    assert_close(out, ref, "out")
    np.testing.assert_array_equal(assign.numpy(), _assignment(ref, _mixed_centers(ft, vt, geo),
                                                              geo).numpy())
    if name == "prop4x4":
        assert jcp._group_w(geo["fold_w"], 16) == 8
    assert not any(cf.LAUNCHES.values())


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_twin_matches_pallas_kernel(name):
    case, geo = CASES[name], _geo(CASES[name])
    feat, value, g = _inputs(case, 2, n=3)
    jdx, jdv, jda, jdb = jcp._cluster_nhwc_pallas_bwd(
        jnp.asarray(feat), jnp.asarray(value), jnp.asarray(g), jnp.float32(ALPHA),
        jnp.float32(BETA), interpret=True, **geo)
    dx, dv, dab = cf.cluster_mix_bwd(torch.from_numpy(feat), torch.from_numpy(value),
                                     torch.from_numpy(g), _ab(), **geo)
    assert dx.dtype == dv.dtype == dab.dtype == torch.float32
    for what, a, w in (("dfeat", dx, jdx), ("dvalue", dv, jdv), ("dalpha", dab[0], jda),
                       ("dbeta", dab[1], jdb)):
        assert_close(a, w, what)


@pytest.mark.parametrize("name", ["gw2", "overlap"])
def test_bf16_twins_match_bf16_pallas_kernels(name):
    case, geo = CASES[name], _geo(CASES[name])
    feat, value, g = _inputs(case, 3, n=3)
    bf = torch.bfloat16
    ft, vt, gt = (torch.from_numpy(a).to(bf) for a in (feat, value, g))
    ref = _jax_fwd(feat, value, geo, jnp.bfloat16)
    out, assign = cf.cluster_mix_fused_plain(ft, vt, _ab(), return_assign=True, **geo)
    assert out.dtype == bf
    jassign = _assignment(ref, _mixed_centers(ft, vt, geo), geo)
    assert (assign == jassign).float().mean().item() >= 0.999
    scale = np.abs(ref).max()
    assert np.abs(out.float().numpy() - ref).mean() <= 0.01 * scale
    want = jcp._cluster_nhwc_pallas_bwd(
        *(jnp.asarray(a, jnp.bfloat16) for a in (feat, value, g)), jnp.float32(ALPHA),
        jnp.float32(BETA), interpret=True, **geo)
    got = cf.cluster_mix_bwd_plain(ft, vt, gt, _ab(), **geo)
    for what, a, w in zip(("dfeat", "dvalue"), got[:2], want[:2]):
        assert a.dtype == bf
        w = np.asarray(w).astype(np.float32)
        assert np.abs(a.float().numpy() - w).mean() <= 0.01 * np.abs(w).max(), what
    wab = np.array([float(want[2]), float(want[3])])
    assert np.abs(got[2].numpy() - wab).max() <= 0.01 * np.abs(wab).max()


@pytest.mark.parametrize("hw,heads,d,fold,prop", [
    ((16, 16), 4, 16, 1, 2),
    ((32, 32), 4, 32, 2, 2),
    ((12, 12), 2, 16, 3, 3),
])
def test_bf16_cluster_mix_matches_jax(hw, heads, d, fold, prop):
    """The module path's plain mix in bf16 with JAX's f32 alpha and beta:
    the cosine in bf16, everything from the sigmoid on in f32, an f32
    result (JAX's promotion; the Cluster's fc2 casts it back)."""
    rng = np.random.default_rng(0)
    feat, value = (rng.standard_normal((2, *hw, heads * d)).astype(np.float32)
                   for _ in range(2))
    geo = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=prop, proposal_w=prop)
    bf = torch.bfloat16
    ref = np.asarray(j_cluster_mix(jnp.asarray(feat, jnp.bfloat16),
                                   jnp.asarray(value, jnp.bfloat16), jnp.float32(ALPHA),
                                   jnp.float32(BETA), **geo))
    cref = np.asarray(j_cluster_mix(jnp.asarray(feat, jnp.bfloat16),
                                    jnp.asarray(value, jnp.bfloat16), jnp.float32(ALPHA),
                                    jnp.float32(BETA), return_center=True, **geo))
    ft, vt = torch.from_numpy(feat).to(bf), torch.from_numpy(value).to(bf)
    alpha, beta = torch.tensor([ALPHA]), torch.tensor([BETA])       # the Cluster's params
    out, assign = cluster_mix(ft, vt, alpha, beta, return_assign=True, **geo)
    centers = cluster_mix(ft, vt, alpha, beta, return_center=True, **geo)
    assert ref.dtype == np.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(ref).max())))
    np.testing.assert_allclose(centers.numpy(), cref, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(cref).max())))
    jassign = _assignment(ref, torch.from_numpy(cref.copy()), geo).long().permute(0, 3, 1, 2)
    np.testing.assert_array_equal(assign.numpy(), jassign.numpy())


@pytest.mark.parametrize("shape,fold,supported", [
    ((2, 32, 32, 64), 2, True),         # 4 heads x 16, 256-token regions
    ((2, 16, 16, 32), 1, True),
    ((2, 8, 8, 32), 4, False),          # 4-token regions: the plain path in both
])
def test_function_gradients_match_jax_vjp(shape, fold, supported):
    """`cluster_mix_fused` under autograd (K7 forward, K7b backward; their
    twins here) against jax.vjp of `cluster_mix_pallas` (its custom VJP),
    f32; where the predicate refuses the shape both take the plain mix."""
    geo = dict(heads=4, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
    assert jcp.pallas_supported(shape, **geo) == tb.pallas_supported(shape, **geo) == supported
    rng = np.random.default_rng(4)
    feat, value, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    out, vjp = jax.vjp(lambda f, v, a, b: jcp.cluster_mix_pallas(f, v, a, b, **geo),
                       jnp.asarray(feat), jnp.asarray(value), jnp.float32(ALPHA),
                       jnp.float32(BETA))
    want = vjp(jnp.asarray(g))
    args = [torch.from_numpy(feat), torch.from_numpy(value), torch.tensor([ALPHA]),
            torch.tensor([BETA])]
    for a in args:
        a.requires_grad_(True)
    got = cf.cluster_mix_fused(*args, **geo)
    fn = type(got.grad_fn).__name__
    assert (fn == "_ClusterMixFusedBackward") == supported, fn
    (got * torch.from_numpy(g)).sum().backward()
    assert_close(got.detach(), out, "out")
    for what, a, w in zip(("dfeat", "dvalue", "dalpha", "dbeta"), args, want):
        assert a.grad.dtype == torch.float32
        assert_close(a.grad, w, what)
    assert not any(cf.LAUNCHES.values())


@pytest.mark.parametrize("fused,drop,drop_path,train,route", [
    (True, 0.0, 0.1, True, "cluster_mix_fused"),    # stochastic depth in training
    (False, 0.0, 0.1, True, "cluster_mix"),         # use_pallas off
    (True, 0.1, 0.0, False, "cluster_mix_fused"),   # dropout: eval as well
    (True, 0.0, 0.1, False, "fused block"),         # drop-path only: eval takes K2/K1
])
def test_cluster_block_routes_the_mix_as_jax(monkeypatch, fused, drop, drop_path, train,
                                             route):
    calls = []
    for name in ("cluster_mix_fused", "cluster_mix"):
        real = getattr(tcb, name)
        monkeypatch.setattr(tcb, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append(_n), _r(*a, **kw))[1])
    blk = tcb.ClusterBlock(16, mlp_ratio=4.0, drop=drop, drop_path=drop_path, heads=4,
                           head_dim=16, fold_h=2, fold_w=2, fused=fused)
    blk.train(train)
    x = torch.randn(2, 16, 32, 32).contiguous(memory_format=torch.channels_last)
    assert blk.fused_ok(x) == (route == "fused block")
    y = blk(x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert calls == ([] if route == "fused block" else [route])
