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


@pytest.mark.slow
def test_r05_forward_512_matches_jax(r05):
    """Trained weights at full size, f32 on the CPU (minutes)."""
    import jax.numpy as jnp

    from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
    from asy_vrnet_tpu.models.efficient_vrnet import create_model as jax_create_model

    params, bstats = r05
    kw = dict(phi="nano", variant="coc_small", compute_dtype="float32",
              use_pallas_cluster=True, prestem_s2d=False)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 512, 512, 3)).astype(np.float32)
    rad = rng.random((1, 512, 512, 4)).astype(np.float32)
    jm = jax_create_model(JaxModelConfig(**kw))
    jdet, jseg = jax.jit(lambda v, i, r: jm.apply(v, i, r, train=False))(
        {"params": params, "batch_stats": bstats}, jnp.asarray(img), jnp.asarray(rad))
    port = create_model(ModelConfig(**kw), device="cpu", weights=R05)
    with torch.no_grad():
        tdet, tseg = port(torch.from_numpy(img), torch.from_numpy(rad))
    for a, b in zip(jdet, tdet):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(tseg.numpy(), np.asarray(jseg), atol=1e-3, rtol=1e-3)
