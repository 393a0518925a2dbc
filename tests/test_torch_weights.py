"""Weight bridge of the port: the committed r05 trained weights (nano,
coc_small, 512^2, flat params/... batch_stats/... npz) load strictly into the
port model, and the bridge is the exact inverse of the JAX package's
torch -> flax converter."""
import os

import numpy as np
import pytest
import torch

import jax

from asy_vrnet_tpu.utils.weights import convert_torch_state_dict
from asy_vrnet_tpu.utils.weights import torch_key_for as jax_torch_key_for

from asy_vrnet_tpu_torch.config import ModelConfig
from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
from asy_vrnet_tpu_torch.utils.weights import load_npz, state_dict_from_flax, torch_key_for

R05 = os.path.join(os.path.dirname(__file__), "..", "model_data", "convergence_tpu_r05",
                   "logs_512c", "best_epoch_weights.npz")


@pytest.fixture(scope="module")
def r05():
    return load_npz(R05)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_r05_strict_load(r05):
    params, bstats = r05
    leaves = list(_paths(params)) + list(_paths(bstats))
    assert len(leaves) == 829
    sd = state_dict_from_flax(params, bstats)
    assert len([k for k in sd if not k.endswith("num_batches_tracked")]) == len(leaves)
    model = create_model(ModelConfig(phi="nano", variant="coc_small"), device="cpu")
    res = model.load_state_dict(sd, strict=False)
    assert res.missing_keys == [] and res.unexpected_keys == []
    k = "backbone.backbone.network.0.0.token_mixer.fc1.weight"
    np.testing.assert_array_equal(
        model.state_dict()[k].numpy()[:, :, 0, 0],
        params["neck"]["backbone"]["stage0"]["block0"]["token_mixer"]["fc1"]["kernel"][0, 0].T)


def test_key_map_matches_jax(r05):
    for tree in r05:
        for path in _paths(tree):
            assert torch_key_for(path) == jax_torch_key_for(path)


def test_bridge_inverts_jax_converter(r05):
    params, bstats = r05
    sd = state_dict_from_flax(params, bstats)
    p2, b2, report = convert_torch_state_dict(sd, params, bstats, verbose=False)
    assert report["missing"] == [] and report["unused"] == []
    for a, b in zip(jax.tree.leaves((params, bstats)), jax.tree.leaves((p2, b2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


R05_KW = dict(phi="nano", variant="coc_small", compute_dtype="float32",
              use_pallas_cluster=True, prestem_s2d=False)


def _r05_input():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((1, 512, 512, 3)).astype(np.float32),
            rng.random((1, 512, 512, 4)).astype(np.float32))


@pytest.mark.slow
def test_r05_forward_512_matches_jax(r05):
    """Trained weights at full size, f32 on the CPU (minutes)."""
    import jax.numpy as jnp

    from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
    from asy_vrnet_tpu.models.efficient_vrnet import create_model as jax_create_model

    params, bstats = r05
    img, rad = _r05_input()
    jm = jax_create_model(JaxModelConfig(**R05_KW))
    jdet, jseg = jax.jit(lambda v, i, r: jm.apply(v, i, r, train=False))(
        {"params": params, "batch_stats": bstats}, jnp.asarray(img), jnp.asarray(rad))
    port = create_model(ModelConfig(**R05_KW), device="cpu", weights=R05)
    with torch.no_grad():
        tdet, tseg = port(torch.from_numpy(img), torch.from_numpy(rad))
    for a, b in zip(jdet, tdet):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(tseg.numpy(), np.asarray(jseg), atol=1e-3, rtol=1e-3)


@pytest.mark.slow
def test_r05_forward_512_parts_from_jax_at_near_ties(r05):
    """Where the port's forward in the test above parts from JAX's: per
    ClusterBlock in call order (JAX's lane-folded stage 0-1 outputs
    unfolded), the tokens whose output differs by more than 1e-3, and the
    port's top-2 margin of the assignment logit (beta + alpha * cos) over
    the heads there.  The first block that parts does so only at near-ties
    (margin <= 1e-6): the two packages picked different proposals at f32
    rounding distance, and later blocks carry that on.  Prints one line a
    block (`-s`)."""
    import jax.numpy as jnp

    from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
    from asy_vrnet_tpu.models.cluster_block import ClusterBlock as JaxClusterBlock
    from asy_vrnet_tpu.models.efficient_vrnet import create_model as jax_create_model

    from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
    from asy_vrnet_tpu_torch.ops import block

    params, bstats = r05
    img, rad = _r05_input()
    jm = jax_create_model(JaxModelConfig(**R05_KW))
    _, state = jax.jit(lambda v, i, r: jm.apply(
        v, i, r, train=False,
        capture_intermediates=lambda m, n: isinstance(m, JaxClusterBlock) and n == "__call__"))(
        {"params": params, "batch_stats": bstats}, jnp.asarray(img), jnp.asarray(rad))
    jblocks = []

    def walk(tree):
        for k, v in tree.items():
            if k == "__call__":
                jblocks.append(np.asarray(v[0])[0])
            elif isinstance(v, dict):
                walk(v)

    walk(jax.device_get(state["intermediates"]))

    port = create_model(ModelConfig(**R05_KW), device="cpu", weights=R05)
    outs, margins = [], []
    plain = block.mixer_block

    def spy(x, stats, wf, bf, wv, bv, w2, b2, ab, **geo):
        p = block._mixer_planes(x, stats, wf, bf, wv, bv, ab, **geo)
        top2 = (ab[1] + ab[0] * p.cos).topk(2, dim=-1).values
        margins[-1] = block._from_regions(top2[..., 0] - top2[..., 1], p.region_hw,
                                          geo["fold_h"], geo["fold_w"])[0].numpy()
        return plain(x, stats, wf, bf, wv, bv, w2, b2, ab, **geo)

    blocks = [m for m in port.modules() if isinstance(m, ClusterBlock)]
    hooks = [m.register_forward_pre_hook(lambda m, a: margins.append(None)) for m in blocks]
    hooks += [m.register_forward_hook(lambda m, a, o: outs.append(
        o.permute(0, 2, 3, 1)[0].numpy().copy())) for m in blocks]
    block.mixer_block = spy
    try:
        with torch.no_grad():
            port(torch.from_numpy(img), torch.from_numpy(rad))
    finally:
        block.mixer_block = plain
        for h in hooks:
            h.remove()

    first, used = None, set()
    for i, (pb, mg) in enumerate(zip(outs, margins)):
        k = next(k for k, jb in enumerate(jblocks) if k not in used
                 and jb.shape[0] == pb.shape[0] and jb.size == pb.size)
        used.add(k)
        far = np.argwhere(np.abs(jblocks[k].reshape(pb.shape) - pb).max(-1) > 1e-3)
        at = sorted(float(mg[y, x].min()) for y, x in far) if mg is not None else None
        print(f"block {i} {list(pb.shape)}: {len(far)} tokens over 1e-3, margins {at}")
        if len(far) and first is None:
            first = (i, at)
    assert first is not None, "the forwards agree: the test above should pass"
    assert first[1] is not None and max(first[1]) <= 1e-6, first
