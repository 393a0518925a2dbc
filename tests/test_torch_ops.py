"""The port's ops and layers (asy_vrnet_tpu_torch) against the JAX package.

Inputs are numpy arrays made from a seed and handed to both packages; JAX
runs on the CPU, its Pallas kernels in interpret mode.  Tolerances are f32:
both sides compute the same arithmetic in another order, so differences are
a few f32 ulps of the values involved (atol 1e-5 .. 5e-5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from asy_vrnet_tpu.models import layers as jl
from asy_vrnet_tpu.models.vr_coc import data_normal as j_data_normal
from asy_vrnet_tpu.models.vr_coc import positional_grid as j_positional_grid
from asy_vrnet_tpu.ops import block_pallas as jb
from asy_vrnet_tpu.ops import resize as jr
from asy_vrnet_tpu.ops.boxes import decode_predictions as j_decode
from asy_vrnet_tpu.ops.cluster import cluster_mix as j_cluster_mix
from asy_vrnet_tpu.ops.nms import non_max_suppression as j_nms

from asy_vrnet_tpu_torch.models import layers as tl
from asy_vrnet_tpu_torch.models.vr_coc import data_normal, positional_grid
from asy_vrnet_tpu_torch.ops import block as tb
from asy_vrnet_tpu_torch.ops import resize as tr
from asy_vrnet_tpu_torch.ops.boxes import decode_predictions
from asy_vrnet_tpu_torch.ops.cluster import cluster_mix
from asy_vrnet_tpu_torch.ops.nms import non_max_suppression
from asy_vrnet_tpu_torch.utils.device import resolve_device
from asy_vrnet_tpu_torch.utils.weights import state_dict_from_flax


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# ---------------------------------------------------------------------------
# cluster mix and the two fused ClusterBlock halves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,heads,d,fold,prop", [
    ((16, 16), 4, 32, 2, 2),
    ((16, 24), 4, 24, 2, 2),
    ((8, 8), 8, 8, 1, 2),
    ((12, 12), 2, 16, 3, 3),     # adaptive windows that overlap
])
def test_cluster_mix_matches_jax(hw, heads, d, fold, prop):
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2, *hw, heads * d)).astype(np.float32)
    value = rng.standard_normal((2, *hw, heads * d)).astype(np.float32)
    kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=prop, proposal_w=prop)
    ref = j_cluster_mix(jnp.asarray(feat), jnp.asarray(value), 1.3, -0.2, **kw)
    out = cluster_mix(_t(feat), _t(value), 1.3, -0.2, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    cref = j_cluster_mix(jnp.asarray(feat), jnp.asarray(value), 1.3, -0.2,
                         return_center=True, **kw)
    cout = cluster_mix(_t(feat), _t(value), 1.3, -0.2, return_center=True, **kw)
    np.testing.assert_allclose(cout.numpy(), np.asarray(cref), atol=2e-5, rtol=1e-5)


# (B, H, W, C, heads, head_dim, fold): a backbone-like stage (C 16, 4x32,
# fold 2, 256-token regions) and a neck-like CoCConv block (4x24 heads)
BLOCK_SHAPES = {
    "backbone": (2, 32, 32, 16, 4, 32, 2),
    "neck": (2, 16, 16, 32, 4, 24, 2),
}


def _mixer_args(shape, seed):
    b, h, w, c, heads, d, _ = shape
    inner = heads * d
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    # non-trivial GN affine / LayerScale / alpha / beta so every fold is used
    return (n(b, h, w, c), n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, inner) * 0.2,
            n(inner) * 0.1, n(c, inner) * 0.2, n(inner) * 0.1, n(inner, c) * 0.2,
            n(c) * 0.1, n(c) * 0.05 + 1.0, np.float32(1.4), np.float32(-0.3))


@pytest.mark.parametrize("name", sorted(BLOCK_SHAPES))
def test_mixer_half_matches_jax_kernel(name):
    shape = BLOCK_SHAPES[name]
    _, _, _, _, heads, d, fold = shape
    args = _mixer_args(shape, 1)
    assert jb.mixer_block_supported(shape[:4], heads=heads, head_dim=d, fold_h=fold,
                                    fold_w=fold, proposal_h=2, proposal_w=2)
    ref, ref_stats = jb.fused_mixer_block_stats(
        *[jnp.asarray(a) for a in args], heads, fold, fold, 2, 2, 1)
    out, stats = tb.fused_mixer_block_stats(
        *[_t(a) for a in args], heads, fold, fold, 2, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats), atol=1e-5, rtol=1e-5)
    assert not any(tb.LAUNCHES.values())   # CPU: plain path


@pytest.mark.parametrize("name", sorted(BLOCK_SHAPES))
def test_mlp_half_matches_jax_kernel(name):
    b, h, w, c = BLOCK_SHAPES[name][:4]
    hid = 4 * c
    rng = np.random.default_rng(2)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = (n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, hid) * 0.2, n(hid) * 0.1,
            n(hid, c) * 0.2, n(c) * 0.1, n(c) * 0.05 + 1.0)
    x = n(b, h, w, c) * 2.0 + 0.5
    ref = jb.fused_mlp_block_pre(jnp.asarray(x), jb.gn1_stats(jnp.asarray(x)),
                                 *[jnp.asarray(a) for a in args])
    stats = tb.gn1_stats(_t(x))
    np.testing.assert_allclose(stats.numpy(), np.asarray(jb.gn1_stats(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-5)
    out = tb.fused_mlp_block_pre(_t(x), stats, *[_t(a) for a in args])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_wrappers_take_plain_path_on_cpu():
    shape = BLOCK_SHAPES["neck"]
    _, _, _, c, heads, d, fold = shape
    x, *_ = _mixer_args(shape, 3)
    rng = np.random.default_rng(4)
    w = lambda *s: _t(rng.standard_normal(s) * 0.2)  # noqa: E731
    xt = _t(x).to(torch.bfloat16)
    st = tb.gn1_stats(xt)
    inner = heads * d
    wargs = (w(c, inner).bfloat16(), w(inner), w(c, inner).bfloat16(), w(inner),
             w(inner, c).bfloat16(), w(c), torch.tensor([1.0, 0.0]))
    kw = dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=2, proposal_w=2)
    out, mom = tb.mixer_block(xt, st, *wargs, **kw)
    ref, rmom = tb.mixer_block_plain(xt, st, *wargs, **kw)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref) and torch.equal(mom, rmom)
    assert not any(tb.LAUNCHES.values())


@pytest.mark.parametrize("shape,heads,head_dim,fold", [
    ((2, 16, 16, 16), 4, 32, 8),     # 2x2 regions: too small
    ((2, 32, 32, 16), 4, 32, 8),
    ((2, 16, 16, 128), 8, 32, 1),
    ((2, 4, 4, 128), 4, 24, 2),
    ((2, 64, 64, 64), 4, 24, 2),
    ((2, 128, 128, 16), 4, 32, 8),
    ((2, 64, 64, 256), 32, 8, 8),    # too many similarity rows per tile
])
def test_fused_predicates_match_jax(shape, heads, head_dim, fold):
    kw = dict(heads=heads, head_dim=head_dim, fold_h=fold, fold_w=fold,
              proposal_h=2, proposal_w=2)
    assert tb.mixer_block_supported(shape, **kw) == jb.mixer_block_supported(shape, **kw)
    assert tb.mlp_block_supported(shape) == jb.mlp_block_supported(shape)


# ---------------------------------------------------------------------------
# layers (f32) against the flax modules, weights carried by the bridge
# ---------------------------------------------------------------------------

LAYERS = {
    # name: (flax module given its instance name, port module, channels);
    # the instance name is one the bridge maps onto the port attribute
    "conv_bn_relu_3x3": (lambda n: jl.ConvBnAct(12, 3, act="relu", name=n),
                         lambda: tl.ConvBnAct(8, 12, 3, act="relu"), 8),
    "conv_bn_s2": (lambda n: jl.ConvBnAct(12, 3, strides=2, act="silu", name=n),
                   lambda: tl.ConvBnAct(8, 12, 3, stride=2, act="silu"), 8),
    "ds_conv": (lambda n: jl.ConvBnAct(8, 3, ds_conv=True, name=n),
                lambda: tl.ConvBnAct(8, 8, 3, ds_conv=True), 8),
    "batchnorm": (lambda n: jl.BatchNorm2d(name=n), lambda: tl.BatchNorm2d(8), 8),
    "groupnorm1": (lambda n: jl.GroupNorm1(name=n), lambda: tl.GroupNorm1(8), 8),
    "mlp": (lambda n: jl.Mlp(32, 8, name=n), lambda: tl.Mlp(8, 32, 8), 8),
    "eca": (lambda n: jl.ECA(name=n), lambda: tl.ECA(40), 40),
    "shuffle_attention": (lambda n: jl.ShuffleAttention(groups=4, name=n),
                          lambda: tl.ShuffleAttention(32, groups=4), 32),
}
_FLAX_NAME = {"batchnorm": "norm", "groupnorm1": "norm1"}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_flax(name):
    mk_f, mk_t, c = LAYERS[name]
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 12, 12, c)) * 1.5 + 0.3).astype(np.float32)
    fname = _FLAX_NAME.get(name, "m")

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, v):
            return mk_f(fname)(v)

    variables = Wrap().init(jax.random.PRNGKey(0), jnp.asarray(x))
    noise = np.random.default_rng(6)

    def perturb(v):
        return np.asarray(v) + noise.normal(0, 0.1, np.shape(v)).astype(np.float32)

    params = jax.tree.map(perturb, variables["params"])
    bstats = jax.tree.map(lambda v: np.abs(perturb(v)) + 0.5,
                          variables.get("batch_stats", {}))
    ref = Wrap().apply({"params": params, "batch_stats": bstats}, jnp.asarray(x))

    port = torch.nn.Module()
    setattr(port, fname, mk_t())
    port.load_state_dict(state_dict_from_flax(params, bstats), strict=True)
    with torch.no_grad():
        out = getattr(port, fname).eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=5e-5, rtol=1e-5)


def test_channel_shuffle_and_eca_kernel_size():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 3, 3, 12)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(tl.channel_shuffle(_nchw(x), 2)),
                                  np.asarray(jl.channel_shuffle(jnp.asarray(x), 2)))
    assert [tl.eca_kernel_size(c) for c in (3, 7, 16, 64, 256)] == \
        [jl.eca_kernel_size(c) for c in (3, 7, 16, 64, 256)]


# ---------------------------------------------------------------------------
# resize ops and small helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_hw,out_hw", [((4, 4), (8, 8)), ((5, 7), (12, 9)),
                                          ((1, 1), (6, 6)), ((8, 8), (32, 32))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(8).standard_normal((2, *in_hw, 3)).astype(np.float32)
    ref = jr.resize_bilinear(jnp.asarray(x), out_hw, align_corners=True)
    out = tr.resize_bilinear(_nchw(x), out_hw, align_corners=True)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5)


def test_upsample_pool_and_adaptive_matrix():
    x = np.random.default_rng(9).standard_normal((2, 5, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(tr.upsample2x(_nchw(x), 4)),
                               np.asarray(jr.upsample2x(jnp.asarray(x), 4)), atol=1e-5)
    np.testing.assert_allclose(_nhwc(tr.global_avg_pool(_nchw(x))),
                               np.asarray(jr.global_avg_pool(jnp.asarray(x))), atol=1e-6)
    for a, b in ((16, 2), (7, 3), (8, 8), (1024, 2)):
        np.testing.assert_array_equal(tr._adaptive_avg_matrix(a, b),
                                      jr._adaptive_avg_matrix(a, b))


def test_data_normal_and_positional_grid():
    x = np.random.default_rng(10).standard_normal((2, 4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(data_normal(_t(x)).numpy(),
                               np.asarray(j_data_normal(jnp.asarray(x))), atol=1e-7)
    np.testing.assert_array_equal(positional_grid(6, 9),
                                  np.asarray(j_positional_grid(6, 9)))


# ---------------------------------------------------------------------------
# decode + NMS on identical raw outputs keep the identical boxes
# ---------------------------------------------------------------------------

def test_decode_and_nms_match_jax():
    rng = np.random.default_rng(11)
    det = [(rng.standard_normal((2, s, s, 9)) * 1.5).astype(np.float32)
           for s in (16, 8, 4)]
    ref = j_decode([jnp.asarray(d) for d in det], (128, 128))
    pred = decode_predictions([_t(d) for d in det], (128, 128))
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    # identical inputs to both NMS implementations, with many overlaps
    pj = np.asarray(ref)
    jout = j_nms(jnp.asarray(pj), 4, conf_thres=0.3, nms_thres=0.4, max_out=50)
    tout = non_max_suppression(_t(pj), 4, conf_thres=0.3, nms_thres=0.4, max_out=50)
    valid = np.asarray(jout["valid"])
    assert valid.sum() > 10
    np.testing.assert_array_equal(tout["valid"].numpy(), valid)
    for k in ("boxes_xyxy", "scores", "obj", "class_conf", "classes"):
        np.testing.assert_array_equal(tout[k].numpy()[valid], np.asarray(jout[k])[valid])


def test_entry_device_defaults_to_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
