"""The port's train step against the JAX package, on the CPU: coc_dryrun,
64^2, batch 2, f32, `use_pallas_cluster=False`, fixed multitask mode (the
uncertainty and frozen-backbone cases are in tests/test_torch_train_modes.py,
so that the two files spread over test workers).

The same seeded numpy batch and the same weights (carried by the bridge) go
through `asy_vrnet_tpu.train.train_step.build_train_step` (jitted) and the
port's.  Tolerances (reasons in tests/torch_parity.py::check_first_step):
after one step `loss`, `loss_det`, `loss_seg`, `f_score`, `num_fg` rtol 1e-4,
parameters and EMA atol 1e-5, BN running stats atol 1e-5 + rtol 1e-5; after a
second step (own state, and a state bridged from JAX after step one) the
metrics rtol 1e-3.  BatchNorm's batch-stat form against the flax modules:
f32 atol 1e-5; bf16 within 2 bf16 ulps of the output's largest value, with
running stats atol 1e-5 (moments are f32 on both sides; 1e-3 behind a bf16
convolution, whose outputs differ by an ulp here and there).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parity as tp

from asy_vrnet_tpu.models import layers as jlayers

from asy_vrnet_tpu_torch.config import Config, CoCVariant, LossConfig, ModelConfig, OptimConfig
from asy_vrnet_tpu_torch.data.synthetic import make_batch
from asy_vrnet_tpu_torch.models import layers as tlayers
from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
from asy_vrnet_tpu_torch.train import state as tstate
from asy_vrnet_tpu_torch.train import train_step as tts
from asy_vrnet_tpu_torch.train.optim import set_learning_rate
from asy_vrnet_tpu_torch.utils import weights as tweights


@pytest.fixture(scope="module")
def fixed():
    return tp.run_one_step_each("fixed")


def test_first_step_matches_jax(fixed):
    tp.check_first_step(fixed)
    assert float(fixed["tm1"]["num_fg"]) > 0


def test_second_step_matches_jax(fixed):
    tp.check_second_step(fixed)


def test_eval_step_matches_jax_and_changes_nothing(fixed):
    """EMA weights, running BN stats, val losses: rtol 1e-4 against JAX."""
    from asy_vrnet_tpu.train.state import eval_variables as j_eval_variables
    from asy_vrnet_tpu.train.train_step import build_eval_step as j_build_eval

    r = fixed
    jcfg, tcfg = tp.train_configs("fixed")
    jm = tp.jax_create_model(jcfg.model)
    batch = make_batch(np.random.default_rng(7), 2, (64, 64))
    want = jax.jit(j_build_eval(jm, jcfg))(j_eval_variables(r["j1"]),
                                           jax.tree.map(jnp.asarray, batch))
    state = tp.port_state_from_jax(tcfg, r["j1"])
    state.model.train()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got = tts.build_eval_step(tcfg, device="cpu")(state, batch)
    for k in ("loss", "loss_det", "loss_seg", "f_score", "num_fg"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    assert state.model.training
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    live = tts.build_eval_step(tcfg, device="cpu")(state, batch, use_ema=False)
    assert float(live["loss"]) != float(got["loss"])


def test_batch_without_onehot_and_uint8_image_give_the_same_step():
    """The lean batch (no seg_onehot; uint8 image normalised in the step)
    takes the same step as the full one, through the oracle seg loss."""
    cfg = Config(model=ModelConfig(variant="coc_dryrun", compute_dtype="float32",
                                   use_pallas_cluster=False, input_size=(64, 64)),
                 loss=LossConfig(max_boxes=16, use_pallas_seg=False))
    batch = make_batch(np.random.default_rng(3), 2, (64, 64))
    raw = np.random.default_rng(4).integers(0, 256, batch["image"].shape).astype(np.uint8)
    from asy_vrnet_tpu_torch.data.preprocess import normalize_image

    full = dict(batch, image=normalize_image(raw))
    lean = {k: v for k, v in dict(batch, image=raw).items() if k != "seg_onehot"}
    losses = []
    for b in (full, lean):
        torch.manual_seed(0)
        state = tstate.create_train_state(cfg, device="cpu")
        set_learning_rate(state.optimizer, 1e-2)
        _, m = tts.build_train_step(cfg, device="cpu")(state, b)
        losses.append({k: float(v) for k, v in m.items()})
    for k in losses[0]:
        np.testing.assert_allclose(losses[1][k], losses[0][k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("module", ["ConvBnAct", "BatchNorm2d"])
def test_batchnorm_batch_stat_form_matches_flax(module, dtype):
    """Output and updated running stats (biased variance, momentum 0.03 in
    ConvBnAct and 0.1 in BatchNorm2d) against the flax modules in train mode."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 8, 8, 4)) * 2 + 0.5).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x = torch.from_numpy(x).to(tdt).float().numpy()      # values the dtype holds
    if module == "ConvBnAct":
        jmod = jlayers.ConvBnAct(features=6, kernel_size=3, act="silu", dtype=jdt)
        tmod = tlayers.ConvBnAct(4, 6, 3, act="silu")
    else:
        jmod = jlayers.BatchNorm2d(dtype=jdt)
        tmod = tlayers.BatchNorm2d(4)
    variables = jax.jit(lambda k, v: jmod.init(k, v, train=False))(jax.random.PRNGKey(0), x)
    c = 6 if module == "ConvBnAct" else 4
    bn = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
          "bias": rng.standard_normal(c).astype(np.float32)}
    stats = {"mean": rng.standard_normal(c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    params = jax.tree.map(np.asarray, variables["params"])
    params["bn"] = bn
    want, mutated = jax.jit(lambda p, s, v: jmod.apply(
        {"params": p, "batch_stats": s}, v, train=True, mutable=["batch_stats"]))(
            params, {"bn": stats}, x)

    tbn = tmod.bn if module == "ConvBnAct" else tmod
    with torch.no_grad():
        if module == "ConvBnAct":
            tmod.conv.weight.copy_(torch.from_numpy(
                np.transpose(params["conv"]["kernel"], (3, 2, 0, 1)).copy()))
        tbn.weight.copy_(torch.from_numpy(bn["scale"]))
        tbn.bias.copy_(torch.from_numpy(bn["bias"]))
        tbn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        tbn.running_var.copy_(torch.from_numpy(stats["var"]))
    tmod.train()
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    got = tmod(xt).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    atol = 1e-5 if dtype == "float32" else 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().detach().numpy(), want, atol=atol)
    new = mutated["batch_stats"]["bn"]
    # behind a bf16 conv the two frameworks' outputs differ by an ulp in a few
    # of the 192 elements a channel averages over
    stat_atol = 1e-3 if (dtype, module) == ("bfloat16", "ConvBnAct") else 1e-5
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(new["mean"]),
                               atol=stat_atol)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(new["var"]),
                               atol=stat_atol)
    assert not np.allclose(tbn.running_var.numpy(), stats["var"])
    # eval mode reads the running stats and leaves them alone
    tmod.eval()
    kept = tbn.running_mean.clone()
    tmod(xt)
    assert torch.equal(tbn.running_mean, kept)


@pytest.mark.parametrize("kind", ["drop_path", "dropout"])
def test_dropout_and_drop_path_follow_training_and_the_generator(kind):
    """Shape and scaling at a non-zero rate (not the bits of the mask):
    kept entries are x / keep, DropPath drops whole samples, the expected
    keep share holds, eval mode is the identity, the same generator seed
    gives the same mask."""
    rate, keep = 0.25, 0.75
    mod = tlayers.DropPath(rate) if kind == "drop_path" else tlayers.Dropout(rate)
    x = torch.ones(64, 8, 4, 4)
    mod.eval()
    assert torch.equal(mod(x), x)
    mod.train()
    g = torch.Generator().manual_seed(3)
    tlayers.set_generator(mod, g)
    y = mod(x)
    assert y.shape == x.shape
    vals = np.unique(y.numpy())
    np.testing.assert_allclose(vals, [0.0, 1 / keep], rtol=1e-6)
    if kind == "drop_path":
        per_sample = y.reshape(64, -1)
        assert ((per_sample == 0).all(1) | (per_sample != 0).all(1)).all()
        share = (per_sample[:, 0] != 0).float().mean().item()
        assert 0.5 < share < 0.95
    else:
        assert abs((y != 0).float().mean().item() - keep) < 0.03
    g.manual_seed(3)
    assert torch.equal(mod(x), y)


def test_cluster_block_with_dropout_trains_and_fused_blocks_refuse_to():
    torch.manual_seed(0)
    blk = ClusterBlock(16, mlp_ratio=2.0, drop=0.2, drop_path=0.3, heads=2, head_dim=8,
                       fused=False)
    tlayers.set_generator(blk, torch.Generator().manual_seed(1))
    x = torch.randn(8, 16, 8, 8).contiguous(memory_format=torch.channels_last)
    blk.eval()
    with torch.no_grad():
        ref = blk(x)
    blk.train()
    y = blk(x.requires_grad_(True))
    y.sum().backward()
    assert y.shape == ref.shape and not torch.allclose(y, ref)
    assert blk.mlp.fc1.weight.grad is not None and x.grad is not None
    # JAX's gate: a fused block refuses the fused halves while dropout is
    # active (drop > 0, or drop-path > 0 in training) and trains on the
    # module path; without dropout it trains through the fused halves
    assert not blk.fused_ok(x) and not blk.eval().fused_ok(x)
    dp = ClusterBlock(16, drop_path=0.3, heads=2, head_dim=8, fused=True)
    assert not dp.train().fused_ok(x) and dp.eval().fused_ok(x)
    fused = ClusterBlock(16, heads=2, head_dim=8, fused=True).train()
    assert fused.fused_ok(x)
    x.grad = None
    fused(x).square().sum().backward()
    assert x.grad is not None
    assert all(p.grad is not None for p in fused.parameters())


def test_variant_drop_rates_reach_the_blocks():
    from asy_vrnet_tpu_torch.models.vr_coc import _stage

    v = CoCVariant(layers=(1, 2, 1, 1), drop_rate=0.1, drop_path_rate=0.2)
    stage = _stage(32, 1, v, fused=False)
    assert [b.drop_path.rate for b in stage] == pytest.approx([0.2 * 1 / 4, 0.2 * 2 / 4])
    assert all(b.mlp.drop.rate == 0.1 for b in stage)


@pytest.mark.parametrize("entry", ["create_train_state", "build_train_step",
                                   "build_eval_step"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    cfg = Config(model=ModelConfig(variant="coc_dryrun", use_pallas_cluster=False,
                                   input_size=(64, 64)))
    fn = {"create_train_state": tstate.create_train_state,
          "build_train_step": tts.build_train_step,
          "build_eval_step": tts.build_eval_step}[entry]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        fn(cfg)
    assert fn(cfg, device="cpu") is not None


def test_a_step_built_for_another_device_refuses_the_state():
    cfg = Config(model=ModelConfig(variant="coc_dryrun", compute_dtype="float32",
                                   use_pallas_cluster=False, input_size=(64, 64)))
    state = tstate.create_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        tts._check_state_device(state, torch.device("cuda"))
    with pytest.raises(ValueError, match="lies on"):
        tstate.create_train_state(cfg, model=state.model.to("meta"), device="cpu")


def test_adam_state_crosses_the_bridge_in_jax_leaf_order():
    """mu, nu and the count of a flat Adam state land on the right
    parameters, laid out like the weights (conv kernels transposed)."""
    cfg = Config(model=ModelConfig(variant="coc_dryrun", compute_dtype="float32",
                                   use_pallas_cluster=False, input_size=(64, 64)),
                 optim=OptimConfig(optimizer="adam"))
    state = tstate.create_train_state(cfg, device="cpu")
    like = jax.eval_shape(lambda: tp.jax_create_model(
        tp.train_configs()[0].model).init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3)),
                                          np.zeros((1, 64, 64, 4)), train=False))
    params = tweights.flax_from_state_dict(state.model.state_dict(), like["params"])
    bstats = tweights.flax_from_state_dict(state.model.state_dict(), like["batch_stats"])
    leaves = jax.tree.leaves(params)
    n = sum(v.size for v in leaves)
    mu = np.arange(n, dtype=np.float32)
    tweights.train_state_from_flax(
        state, params, bstats, {"mu": mu, "nu": 2 * mu, "count": 7}, np.float32(0.25),
        params, bstats, ema_updates=7, step=7)
    assert state.log_var.item() == 0.25 and state.step == 7 and state.ema_updates == 7.0
    named = dict(state.model.named_parameters())
    offset = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        key = tweights.torch_key_for(tuple(p.key for p in path))
        piece = mu[offset:offset + leaf.size].reshape(leaf.shape)
        st = state.optimizer.state[named[key]]
        want = tweights._to_torch_leaf(path[-1].key, piece)
        np.testing.assert_array_equal(st["exp_avg"].numpy(), want, err_msg=key)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), 2 * want, err_msg=key)
        assert st["step"].item() == 7
        offset += leaf.size
    # and one Adam step runs from the bridged state
    set_learning_rate(state.optimizer, 1e-3)
    batch = make_batch(np.random.default_rng(0), 2, (64, 64))
    _, m = tts.build_train_step(cfg, device="cpu")(state, batch)
    assert np.isfinite(float(m["loss"])) and state.step == 8
