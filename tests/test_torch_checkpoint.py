"""The port's weight bridge inverse, weights-only npz, partial load, weight
re-init and full-state checkpoints, on the CPU, against the JAX package where
it has a counterpart.  Everything here is exact: the npz holds the same f32
bits both ways, `reinit_params` draws from the same numpy generator in the
same leaf order, and a resumed step runs the same CPU arithmetic as an
uninterrupted one."""
import numpy as np
import pytest
import torch

import jax

from tests.torch_parity import one_torch_thread  # noqa: F401

from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
from asy_vrnet_tpu.models.efficient_vrnet import create_model as jax_create_model
from asy_vrnet_tpu.train import checkpoint as jck
from asy_vrnet_tpu.utils.init import reinit_params as jax_reinit

from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig, OptimConfig
from asy_vrnet_tpu_torch.data.synthetic import make_batch
from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
from asy_vrnet_tpu_torch.train import checkpoint as tck
from asy_vrnet_tpu_torch.train.optim import set_learning_rate
from asy_vrnet_tpu_torch.train.state import create_train_state
from asy_vrnet_tpu_torch.train.train_step import build_train_step
from asy_vrnet_tpu_torch.utils.init import reinit_params
from asy_vrnet_tpu_torch.utils.weights import (
    flax_collection,
    flax_from_port,
    flax_path_for,
    torch_key_for,
)

R05 = "model_data/convergence_tpu_r05/logs_512c/best_epoch_weights.npz"
SIZE = 64


def _kw(variant):
    return dict(phi="nano", variant=variant, compute_dtype="float32", input_size=(SIZE, SIZE))


@pytest.fixture(scope="module")
def dryrun_like():
    """jax.eval_shape of JAX's init of nano coc_dryrun (no compile)."""
    jm = jax_create_model(JaxModelConfig(**_kw("coc_dryrun"), prestem_s2d=False))
    zeros = lambda c: np.zeros((1, SIZE, SIZE, c), np.float32)  # noqa: E731
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), zeros(3), zeros(4),
                                          train=False))


def _flat(tree, prefix=""):
    return {prefix + jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("variant", ["coc_small", "coc_dryrun"])
def test_flax_path_for_inverts_torch_key_for(variant):
    sd = create_model(ModelConfig(**_kw(variant)), device="cpu").state_dict()
    keys = [k for k in sd if not k.endswith("num_batches_tracked")]
    assert all(torch_key_for(flax_path_for(k)) == k for k in keys)
    assert {flax_collection(k) for k in keys if k.endswith("running_var")} == {"batch_stats"}
    trees = flax_from_port(sd)
    assert len(_flat(trees["params"])) + len(_flat(trees["batch_stats"])) == len(keys)


def test_flax_from_port_has_jax_paths_and_shapes(dryrun_like):
    trees = flax_from_port(create_model(ModelConfig(**_kw("coc_dryrun")), device="cpu")
                           .state_dict())
    for col in ("params", "batch_stats"):
        want = {k: v.shape for k, v in _flat(dryrun_like[col]).items()}
        got = {k: v.shape for k, v in _flat(trees[col]).items()}
        assert got == want, col


def test_r05_export_round_trips_bit_for_bit(tmp_path):
    """r05's npz into the port model and out through `save_weights`: r05's
    829 keys with bit-equal arrays, dtypes and shapes (0-d sim_alpha too)."""
    model = create_model(ModelConfig(**_kw("coc_small")), device="cpu", weights=R05)
    out = tmp_path / "w.npz"
    tck.save_weights(str(out), model.state_dict())
    with np.load(R05) as ref, np.load(out) as got:
        assert len(ref.files) == 829 and sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            a, b = ref[k], got[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(b, a, err_msg=k)
    assert tck.latest_checkpoint(str(tmp_path)) is None


def test_port_npz_loads_into_jax_with_every_leaf(tmp_path, dryrun_like, capsys):
    model = create_model(ModelConfig(**_kw("coc_dryrun")), device="cpu")
    path = str(tmp_path / "port.npz")
    tck.save_weights(path, model.state_dict())
    src = jck.load_weights(path)
    for col in ("params", "batch_stats"):
        _, loaded, kept = jck.partial_load(dryrun_like[col], src[col])
        assert len(loaded) == len(_flat(dryrun_like[col])) and not kept, col
    assert tck.load_weights(path).keys() == src.keys()
    capsys.readouterr()


def test_partial_load_counts_match_jax(capsys):
    model = create_model(ModelConfig(**_kw("coc_dryrun")), device="cpu")
    target = flax_from_port(model.state_dict())["params"]
    rng = np.random.default_rng(0)
    source = jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(np.float32), target)
    del source["head"]["cls_pred0"]                            # missing leaves
    source["neck"]["aspp"]["branch1_conv"]["kernel"] = np.zeros((1, 1, 2, 2), np.float32)
    source["neck"]["backbone"]["stage0"]["block0"]["layer_scale_1"] = np.zeros(3)
    got, tl, tk = tck.partial_load(target, source)
    tout = capsys.readouterr().out
    want, jl, jk = jck.partial_load(target, source)
    assert capsys.readouterr().out == tout
    assert (tl, tk) == (jl, jk) and len(tk) == 4 and len(tl) > 400
    for (p, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                              jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(p))


@pytest.fixture
def one_blas_thread():
    """One BLAS thread for the orthogonal init's QR factorisations (both
    packages call np.linalg.qr): OpenBLAS's own pool under the suite's
    workers made one such test take minutes."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1):
        yield


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_reinit_params_matches_jax_bit_for_bit(init_type, dryrun_like, one_blas_thread):
    torch.manual_seed(0)
    model = create_model(ModelConfig(**_kw("coc_dryrun")), device="cpu")
    before = flax_from_port(model.state_dict())["params"]
    assert {k: v.shape for k, v in _flat(before).items()} == {
        k: v.shape for k, v in _flat(dryrun_like["params"]).items()}
    want = jax_reinit(before, seed=7, init_type=init_type, init_gain=0.03)
    reinit_params(model, seed=7, init_type=init_type, init_gain=0.03)
    got, old = _flat(flax_from_port(model.state_dict())["params"]), _flat(before)
    changed = 0
    for k, w in _flat(want).items():
        assert got[k].dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)
        changed += not np.array_equal(got[k], old[k])
    assert changed > 100


def test_reinit_none_keeps_the_model():
    model = create_model(ModelConfig(**_kw("coc_dryrun")), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    reinit_params(model, 0, "none")
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    with pytest.raises(NotImplementedError):
        reinit_params(model, 0, "uniform")


def _cfg(optimizer):
    return Config(model=ModelConfig(**_kw("coc_dryrun"), use_pallas_cluster=False),
                  loss=LossConfig(max_boxes=8, use_pallas_seg=False),
                  optim=OptimConfig(optimizer=optimizer))


def _state(cfg, seed=3):
    torch.manual_seed(seed)
    state = create_train_state(cfg, device="cpu")
    set_learning_rate(state.optimizer, 1e-3)
    return state


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_resumed_step_equals_the_uninterrupted_one(tmp_path, optimizer):
    """Step 1, save the full state, restore it into a fresh state, step 2:
    the bits of the run that never stopped (module path, f32, coc_dryrun
    64^2, batch 2)."""
    cfg = _cfg(optimizer)
    step = build_train_step(cfg, device="cpu")
    batches = [make_batch(np.random.default_rng(s), 2, (SIZE, SIZE), max_boxes=8)
               for s in (11, 12)]
    run, _ = step(_state(cfg), batches[0])
    path = tck.save_checkpoint(str(tmp_path / "ckpt"), run, epoch=1)
    assert path.endswith("step_1.pt") and tck.latest_checkpoint(str(tmp_path / "ckpt")) == path
    run, m_run = step(run, batches[1])

    fresh = _state(cfg, seed=9)
    assert tck.restore_checkpoint(path, fresh) == 1 and fresh.step == 1
    fresh, m_res = step(fresh, batches[1])
    assert fresh.step == run.step == 2 and fresh.ema_updates == run.ema_updates
    for k in m_run:
        assert torch.equal(m_res[k], m_run[k]), k
    for k, v in run.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for k, v in run.ema.items():
        assert torch.equal(fresh.ema[k], v), k
    assert torch.equal(fresh.log_var, run.log_var)
    s_run, s_res = run.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert s_run.keys() == s_res.keys()
    for i in s_run:
        for f, v in s_run[i].items():
            assert torch.equal(torch.as_tensor(s_res[i][f]), torch.as_tensor(v)), (i, f)


def test_checkpoint_keeps_the_dropout_generator(tmp_path):
    from asy_vrnet_tpu_torch.models.layers import set_generator

    cfg = _cfg("sgd")
    state = _state(cfg)
    gen = torch.Generator().manual_seed(5)
    set_generator(state.model, gen)
    torch.rand(3, generator=gen)
    path = tck.save_checkpoint(str(tmp_path), state, epoch=4)
    want = torch.rand(4, generator=gen)
    fresh = _state(cfg)
    gen2 = torch.Generator().manual_seed(0)
    set_generator(fresh.model, gen2)
    assert tck.restore_checkpoint(path, fresh) == 4
    assert torch.equal(torch.rand(4, generator=gen2), want)
    with pytest.raises(ValueError, match="generator"):
        tck.restore_checkpoint(path, _state(cfg))
