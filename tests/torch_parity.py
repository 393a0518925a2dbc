"""Shared set-up for the whole-model parity tests of the PyTorch port: one
JAX EfficientVRNet (f32, fused Pallas block kernels in interpret mode,
literal pre-stem) and the port model carrying the same random weights
through the bridge."""
import numpy as np

import jax

from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
from asy_vrnet_tpu.models.efficient_vrnet import create_model as jax_create_model
from asy_vrnet_tpu.models.efficient_vrnet import init_model

from asy_vrnet_tpu_torch.config import ModelConfig
from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
from asy_vrnet_tpu_torch.utils.weights import state_dict_from_flax


def config_kwargs(size: int) -> dict:
    return dict(phi="nano", variant="coc_dryrun", compute_dtype="float32",
                use_pallas_cluster=True, prestem_s2d=False, input_size=(size, size))


def model_pair(size: int):
    """-> (jax_model, variables, port_model).  Params get N(0, 0.05) noise on
    top of the init (so LayerScale, GN affine and alpha/beta are far from
    their identity-ish init values and every block contributes)."""
    kw = config_kwargs(size)
    jm = jax_create_model(JaxModelConfig(**kw))
    params, bstats = init_model(jm, jax.random.PRNGKey(0), input_size=(size, size))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, v.shape).astype(np.float32), params)
    bstats = jax.tree.map(np.asarray, bstats)
    port = create_model(ModelConfig(**kw), device="cpu")
    port.load_state_dict(state_dict_from_flax(params, bstats), strict=True)
    return jm, {"params": params, "batch_stats": bstats}, port


def inputs(size: int, seed: int = 2, batch: int = 2):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    rad = rng.random((batch, size, size, 4)).astype(np.float32)
    return img, rad


def fused_blocks(port, img, rad) -> list[bool]:
    """Which ClusterBlocks take the fused path for these inputs, in call order."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(m.fused_ok(a[0])))
             for m in port.modules() if isinstance(m, ClusterBlock)]
    import torch

    with torch.no_grad():
        port(torch.from_numpy(img), torch.from_numpy(rad))
    for h in hooks:
        h.remove()
    return seen


def check_forward_and_boxes(jm, variables, port, size: int):
    """Port f32 forward == JAX f32 forward; decode + NMS keep the same boxes.

    Tolerance: atol 5e-5, rtol 1e-4 on det and seg.  Both sides run the same
    f32 arithmetic in another order through ~60 layers; measured differences
    are <= 6e-6 on values of magnitude <= 3."""
    import jax.numpy as jnp
    import torch

    from asy_vrnet_tpu.ops.boxes import decode_predictions as j_decode
    from asy_vrnet_tpu.ops.nms import non_max_suppression as j_nms

    from asy_vrnet_tpu_torch.ops.boxes import decode_predictions
    from asy_vrnet_tpu_torch.ops.nms import non_max_suppression

    img, rad = inputs(size)
    fwd = jax.jit(lambda v, i, r: jm.apply(v, i, r, train=False))
    jdet, jseg = fwd(variables, jnp.asarray(img), jnp.asarray(rad))
    jdet = [np.array(d) for d in jdet]
    with torch.no_grad():
        tdet, tseg = port(torch.from_numpy(img), torch.from_numpy(rad))
    for a, b in zip(jdet, tdet):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), a, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(tseg.numpy(), np.asarray(jseg), atol=5e-5, rtol=1e-4)

    hw = (size, size)
    conf = float(np.quantile(np.asarray(j_decode([jnp.asarray(d) for d in jdet], hw))
                             [..., 4], 0.8)) * 0.5
    # identical raw outputs through both decode + NMS: identical kept boxes
    jout = j_nms(j_decode([jnp.asarray(d) for d in jdet], hw), 4,
                 conf_thres=conf, nms_thres=0.3, max_out=40)
    tout = non_max_suppression(decode_predictions([torch.from_numpy(d) for d in jdet], hw),
                               4, conf_thres=conf, nms_thres=0.3, max_out=40)
    valid = np.asarray(jout["valid"])
    assert valid.sum() >= 5
    np.testing.assert_array_equal(tout["valid"].numpy(), valid)
    np.testing.assert_array_equal(tout["classes"].numpy()[valid],
                                  np.asarray(jout["classes"])[valid])
    np.testing.assert_allclose(tout["boxes_xyxy"].numpy()[valid],
                               np.asarray(jout["boxes_xyxy"])[valid], atol=1e-6)
    # each package's own outputs: the same boxes within the forward tolerance
    own = non_max_suppression(decode_predictions(tdet, hw), 4, conf_thres=conf,
                              nms_thres=0.3, max_out=40)
    np.testing.assert_array_equal(own["valid"].numpy(), valid)
    np.testing.assert_array_equal(own["classes"].numpy()[valid],
                                  np.asarray(jout["classes"])[valid])
    np.testing.assert_allclose(own["boxes_xyxy"].numpy()[valid],
                               np.asarray(jout["boxes_xyxy"])[valid], atol=1e-4)
