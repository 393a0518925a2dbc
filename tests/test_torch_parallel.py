"""Data-parallel training in the port (`asy_vrnet_tpu_torch/parallel/`): two
gloo CPU ranks against the port's single-process step on the same global
batch, and against the JAX package's `build_parallel_train_step`.

Under GSPMD the JAX step is one program over the global batch, so its
BatchNorm statistics, the radar gate's min-max, the detection normaliser,
the segmentation losses' sums and counts and the dropout masks are the
global batch's (`tests/test_parallel.py` holds the 8-way step to the
single-device one).  One module-scoped spawn of two ranks (the cases in
`tests/torch_parallel_ranks.py`: fixed and uncertainty multitask, the
frozen backbone, drop-path at rate 0.6 and train_remat "blocks", over the
fused seg loss's twins and the unfused losses, focal and CE) runs each
case's parallel train and val step at 64^2, f32, global batch 4 (2 a
rank); the test process meanwhile runs the same cases in one process.  A
slow-marked test holds the two-rank step against one JAX parallel step on
2 of the 8 virtual CPU devices.

Bounds (`test_parallel.py`'s): losses and metrics rtol 1e-4; parameters,
log-var, EMA and BN running stats atol 1e-5 (f32, the same arithmetic
except that a global sum is the sum of the ranks' partial sums, and BN's
global moments the mean of the ranks' moments)."""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_ranks as ranks
from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

from asy_vrnet_tpu.parallel import mesh as jmesh
from asy_vrnet_tpu.parallel.sharding_rules import param_sharding_rules as jax_rules
from asy_vrnet_tpu.train.train_step import build_train_step as jax_build_train_step

from asy_vrnet_tpu_torch.data.dataset import DataLoader, WaterScenesDataset, read_annotation_file
from asy_vrnet_tpu_torch.data.synthetic import write_synthetic_voc_dataset
from asy_vrnet_tpu_torch.parallel.mesh import free_port, make_mesh
from asy_vrnet_tpu_torch.parallel.sharding_rules import param_sharding_rules
from asy_vrnet_tpu_torch.utils.weights import flax_from_state_dict, flax_path_for

CASES = tuple(ranks.CASES)
METRICS = ("loss", "loss_det", "loss_seg", "f_score", "num_fg")


def _jax_parallel_step():
    """JAX's parallel step over 2 devices from `noisy_model_pair`'s weights
    (those the ranks start from) on the same global batch; module-path
    blocks, JAX's oracle seg loss."""
    tcfg, _ = ranks.case_config("fixed")
    jcfg, _ = tp.train_configs("fixed", ranks.SIZE, use_pallas_cluster=False)
    jm, j0, tx = tp.jax_train_setup(jcfg, tcfg, size=ranks.SIZE, seed=1)
    mesh = jmesh.make_mesh(2)
    step = jmesh.build_parallel_train_step(jax_build_train_step(jm, jcfg, tx), mesh)
    batch = jax.tree.map(jnp.asarray, ranks.batches()[0])
    j1, m1 = step(jmesh.replicate_state(j0, mesh), jmesh.shard_batch(batch, mesh))
    return jax.tree.map(np.asarray, j1), {k: float(v) for k, v in m1.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    ctx = torch.multiprocessing.spawn(
        ranks.run_ranks, args=(f"tcp://127.0.0.1:{free_port()}", str(out)), nprocs=2,
        join=False)
    try:
        ranks.register_droppath_variant()
        single = {name: ranks.run_case(name) for name in CASES}
        x, cot = ranks.min_on_rank1()
        grad = ranks.data_normal_grad(x, cot)
        replicated = ranks.tp_forward(ranks.noisy_model(ranks.case_config("fixed")[0].model))
    finally:
        deadline = time.time() + 600
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("the two ranks did not end within 600 s")
    got = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(single=single, ranks=got, grad=grad, replicated=replicated)


def _close(got: dict, want: dict, atol: float, what: str):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", CASES)
def test_parallel_step_gives_the_single_process_step(runs, case):
    """Loss and metrics, every parameter and BN running stat, the EMA and
    the log-variance after one step on two ranks equal one process's step
    on the whole batch."""
    got, want = runs["ranks"][0]["cases"][case], runs["single"][case]
    for k in METRICS:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-4,
                                   err_msg=k)
    _close(got["state"], want["state"], 1e-5, "state")
    _close(got["ema"], want["ema"], 1e-5, "ema")
    np.testing.assert_allclose(got["log_var"], want["log_var"], rtol=0, atol=1e-5)
    assert got["step"] == want["step"] == 1
    if case == "uncertainty":
        assert want["log_var"] != 0.0         # the hand update ran
    if case == "frozen":                      # the backbone's weights kept their bits
        _, _, start = ranks.start_state(case)
        for k, v in start.model.named_parameters():
            if k.startswith("backbone.backbone."):
                assert torch.equal(got["state"][k], v.detach()), k


@pytest.mark.parametrize("case", CASES)
def test_parallel_eval_step_gives_the_global_val_metrics(runs, case):
    got, want = runs["ranks"][0]["cases"][case]["val"], runs["single"][case]["val"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_the_ranks_hold_one_state(runs, case):
    """Replicated in, replicated out: the same bits on both ranks (both add
    the same all-reduced gradient to the same parameters)."""
    a, b = (r["cases"][case] for r in runs["ranks"])
    assert a["metrics"] == b["metrics"] and a["val"] == b["val"]
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    for k in a["ema"]:
        assert torch.equal(a["ema"][k], b["ema"][k]), k


@pytest.mark.slow
def test_parallel_step_gives_jax_parallel_step(runs):
    """The two-rank step ("fixed": fused blocks where they apply, the fused
    seg loss's twins) against JAX's `build_parallel_train_step` on a
    2-device mesh (module-path blocks, its oracle seg loss): metrics rtol
    1e-4, parameters and EMA atol 1e-5, BN stats atol 1e-5 + rtol 1e-5
    (`torch_parity.check_first_step`'s bounds).

    Slow: the JAX parallel step's compile alone takes ~47 s on an idle
    host (~2x a one-device step's), more than half of the 90 s of worker
    time this file and the CLI's rank cases may take in tier-1.  Tier-1
    still holds the chain: the two-rank step against the one-process step
    here, and that step against JAX's in the `test_torch_train_*.py`
    files."""
    got = runs["ranks"][0]["cases"]["fixed"]
    j1, jm1 = _jax_parallel_step()
    for k in METRICS:
        np.testing.assert_allclose(got["metrics"][k], jm1[k], rtol=1e-4, err_msg=k)
    tp.assert_trees_close(flax_from_state_dict(got["state"], j1.params), j1.params, 1e-5,
                          "params")
    tp.assert_trees_close(flax_from_state_dict(got["ema"], j1.ema_params), j1.ema_params,
                          1e-5, "ema_params")
    for name, sd, want in (("batch_stats", got["state"], j1.batch_stats),
                           ("ema_batch_stats", got["ema"], j1.ema_batch_stats)):
        have = flax_from_state_dict(sd, want)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(have)):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")


def test_data_normal_gradient_reaches_the_rank_that_holds_the_min(runs):
    """The radar gate's min lies only in rank 1's rows and its max is tied
    across the ranks: each rank's gradient is its rows of the one-process
    gradient (the min's whole gradient on rank 1's element, the max's split
    evenly over the two ranks)."""
    x, _ = ranks.min_on_rank1()
    got = np.concatenate([r["data_normal_grad"] for r in runs["ranks"]])
    np.testing.assert_allclose(got, runs["grad"], rtol=1e-6, atol=1e-7)
    assert (x[:2] > x.min()).all() and (x[2:] == x.min()).sum() == 1
    assert got[3, 1, 2, 3] != 0.0


def test_shard_params_forward_equals_the_replicated_forward(runs):
    """Wide weights (>= 32 output channels) held as output-channel slices
    over a ("model": 2) mesh, gathered at use: the forward equals the
    replicated one (atol 1e-5) on both ranks."""
    for r in runs["ranks"]:
        assert len(r["tp_sharded"]) > 10
        for got, want in zip(r["tp_forward"], runs["replicated"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_replicate_state_refuses_a_model_axis(runs):
    """Training over "model" is not implemented: `replicate_state` (which
    `fit` calls) refuses a ("model": 2) mesh and, on the data mesh, a model
    that `shard_params` sliced, on both ranks and before any collective."""
    for r in runs["ranks"]:
        assert len(r["tp_replicate_refused"]) == 2
        assert all('over a "model" axis' in m for m in r["tp_replicate_refused"])


@pytest.mark.parametrize("model_parallel,min_channels", [(2, 64), (4, 32)])
def test_param_sharding_rules_select_jax_leaves(model_parallel, min_channels):
    """The port's rule shards a parameter iff JAX's rule shards its flax
    leaf, on the axis that holds the leaf's last (output-channel) axis."""
    kw = tp.config_kwargs(ranks.SIZE)
    from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
    from asy_vrnet_tpu.models.efficient_vrnet import create_model as jax_create_model
    from asy_vrnet_tpu_torch.config import ModelConfig

    jm = jax_create_model(JaxModelConfig(**kw))
    zeros = lambda c: np.zeros((1, ranks.SIZE, ranks.SIZE, c), np.float32)  # noqa: E731
    like = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), zeros(3), zeros(4),
                                          train=False))["params"]
    mesh = jmesh.make_mesh(8, model_parallel=model_parallel)
    want = jax_rules(like, mesh, min_channels=min_channels)
    model = ranks.create_model(ModelConfig(**kw), device="cpu")
    got = param_sharding_rules(model, dict(mesh.shape), min_channels=min_channels)
    n_sharded = 0
    for key, dim in got.items():
        node = want
        for part in flax_path_for(key):
            node = node[part]
        spec = tuple(node.spec)
        leaf = dict(model.named_parameters())[key]
        if dim is None:
            assert "model" not in spec, key
        else:
            n_sharded += 1
            assert spec[-1] == "model" and all(s is None for s in spec[:-1]), key
            # the port axis that holds flax's last axis
            flax_last = like_shape(like, key)[-1]
            assert leaf.shape[dim] == flax_last, key
    assert n_sharded == sum("model" in tuple(s.spec) for s in jax.tree.leaves(want)) > 0


def like_shape(like, key):
    node = like
    for part in flax_path_for(key):
        node = node[part]
    return node.shape


def test_make_mesh_refuses_an_axis_that_does_not_divide():
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        make_mesh(3, model_parallel=2)


def test_rank_loaders_concatenate_to_the_global_batches(tmp_path):
    """Two rank loaders (the same seed, shuffled, augmentation on): the rows
    of every global batch, concatenated, equal the one-process loader's
    batch bit for bit, for two epochs."""
    meta = write_synthetic_voc_dataset(str(tmp_path), num_images=8, hw=(ranks.SIZE,) * 2)

    def loader(rank, world):
        ds = WaterScenesDataset(read_annotation_file(meta["annotation_path"]),
                                (ranks.SIZE, ranks.SIZE), 4, 9, meta["radar_root"],
                                meta["seg_dataset_path"], max_boxes=8, augment=True, seed=3)
        return DataLoader(ds, 4, shuffle=True, seed=3, workers=1, rank=rank, world=world)

    one, parts = loader(0, 1), [loader(r, 2) for r in range(2)]
    for _ in range(2):
        want = list(one)
        got = [list(p) for p in parts]
        assert len(want) == len(got[0]) == len(got[1]) == 2
        for w, a, b in zip(want, *got):
            assert a["image"].shape[0] == 2
            for k in w:
                if k == "image_id":
                    assert list(a[k]) + list(b[k]) == list(w[k])
                else:
                    np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), w[k],
                                                  err_msg=k)
    with pytest.raises(ValueError, match="equal shards"):
        DataLoader(one.dataset, 3, rank=0, world=2)
