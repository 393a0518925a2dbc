"""What the two gloo CPU ranks of `test_torch_parallel.py` run, and the
single-process references they are held against.  torch and the port only:
the test spawns `run_ranks` in new processes, which import this module.

Every case starts from the same weights (the port's initialisation under
seed 1 plus N(0, 0.05) noise, as `torch_parity.noisy_model_pair` draws them,
so the JAX package can carry the same weights) and takes one train step on
one global batch of 4 at 64^2, f32, then one val step on another."""
import dataclasses
import os
import types

import numpy as np
import torch

from asy_vrnet_tpu_torch import config as tconfig
from asy_vrnet_tpu_torch.config import Config, LossConfig, ModelConfig, OptimConfig, TrainConfig
from asy_vrnet_tpu_torch.data.synthetic import make_batch
from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
from asy_vrnet_tpu_torch.models.layers import set_generator
from asy_vrnet_tpu_torch.models.vr_coc import data_normal
from asy_vrnet_tpu_torch.parallel import collectives
from asy_vrnet_tpu_torch.parallel import mesh as pm
from asy_vrnet_tpu_torch.parallel.sharding_rules import shard_params
from asy_vrnet_tpu_torch.train.optim import set_learning_rate
from asy_vrnet_tpu_torch.train.state import create_train_state, float_state
from asy_vrnet_tpu_torch.train.train_step import build_eval_step, build_train_step

SIZE, BATCH, WORLD = 64, 4, 2
DROPPATH_VARIANT = "coc_dryrun_droppath_parallel"
# case -> (multitask mode, freeze_backbone, drop-path, train_remat, seg loss:
# the fused path's plain twins or the unfused losses, focal or CE)
CASES = {
    "fixed": ("fixed", False, False, "none", "fused", True),
    "uncertainty": ("uncertainty", False, False, "none", "plain", True),
    "frozen": ("fixed", True, False, "none", "plain", False),
    "droppath": ("fixed", False, True, "none", "fused", False),
    "remat_blocks": ("fixed", False, False, "blocks", "fused", True),
}
DROP_SEED = 7


def register_droppath_variant():
    """coc_dryrun with drop_path_rate 0.6 (some samples of the batch drop a
    block) in the port's variant table of this process."""
    tconfig.COC_VARIANTS[DROPPATH_VARIANT] = dataclasses.replace(
        tconfig.COC_VARIANTS["coc_dryrun"], drop_path_rate=0.6)


def case_config(name: str) -> tuple[Config, bool]:
    mode, freeze, drop, remat, seg, focal = CASES[name]
    model = ModelConfig(phi="nano", variant=DROPPATH_VARIANT if drop else "coc_dryrun",
                        compute_dtype="float32", use_pallas_cluster=True, prestem_s2d=False,
                        input_size=(SIZE, SIZE), train_remat=remat)
    loss = LossConfig(multitask_mode=mode, max_boxes=16, use_pallas_seg=seg == "fused",
                      focal_loss=focal)
    return Config(model=model, loss=loss, optim=OptimConfig(init_lr=1e-2),
                  train=TrainConfig(batch_size=2)), freeze


def noisy_model(model_cfg: ModelConfig, seed: int = 1):
    """`torch_parity.noisy_model_pair`'s port model, without JAX."""
    torch.manual_seed(seed)
    model = create_model(model_cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def start_state(name: str):
    cfg, freeze = case_config(name)
    state = create_train_state(cfg, noisy_model(cfg.model), device="cpu")
    set_learning_rate(state.optimizer, 1e-2)
    if CASES[name][2]:
        set_generator(state.model, torch.Generator().manual_seed(DROP_SEED))
    return cfg, freeze, state


def batches():
    """(train batch, val batch), global."""
    return [make_batch(np.random.default_rng(s), BATCH, (SIZE, SIZE), max_boxes=16)
            for s in (0, 1)]


def snapshot(state, metrics, val_metrics) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "val": {k: float(v) for k, v in val_metrics.items()},
            "state": {k: v.detach().clone() for k, v in float_state(state.model).items()},
            "ema": {k: v.clone() for k, v in state.ema.items()},
            "log_var": float(state.log_var.detach()), "step": state.step}


def run_case(name: str, mesh=None) -> dict:
    """One train step and one val step of case `name`: on the global batch,
    or with `mesh` as this rank's part of a parallel step."""
    cfg, freeze, state = start_state(name)
    train, val = batches()
    step = build_train_step(cfg, freeze_backbone=freeze, device="cpu")
    ev = build_eval_step(cfg, device="cpu")
    if mesh is not None:
        pm.replicate_state(state, mesh)
        step = pm.build_parallel_train_step(step, mesh)
        ev = pm.build_parallel_eval_step(ev, mesh)
        train, val = pm.shard_batch(train, mesh), pm.shard_batch(val, mesh)
    state, metrics = step(state, train)
    return snapshot(state, metrics, ev(state, val))


def min_on_rank1():
    """(x, cotangent): a (4, 2, 4, 4) map whose only global minimum lies in
    row 3 (rank 1's rows are 2-3) and whose maximum is tied between row 0
    and row 2 (one element on each rank)."""
    rng = np.random.default_rng(4)
    x = rng.random((BATCH, 2, 4, 4)).astype(np.float32)
    x[3, 1, 2, 3] = -5.0
    x[0, 0, 1, 1] = x[2, 1, 0, 2] = 9.0
    return x, rng.standard_normal(x.shape).astype(np.float32)


def data_normal_grad(x: np.ndarray, cot: np.ndarray) -> np.ndarray:
    """d/dx of sum(data_normal(x) * cot) for the rows this process holds."""
    xt = torch.from_numpy(x).requires_grad_(True)
    (data_normal(xt) * torch.from_numpy(cot)).sum().backward()
    return xt.grad.numpy()


def tp_inputs():
    rng = np.random.default_rng(6)
    return (torch.from_numpy(rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)),
            torch.from_numpy(rng.random((2, SIZE, SIZE, 4)).astype(np.float32)))


def tp_forward(model) -> list[np.ndarray]:
    model.eval()
    with torch.no_grad():
        det, seg = model(*tp_inputs())
    return [t.numpy() for t in (*det, seg)]


def run_ranks(rank: int, init_method: str, out_dir: str) -> None:
    """Rank `rank` of 2 gloo CPU ranks: every case through the parallel
    steps on a ("data": 2) mesh, `data_normal`'s gradient over the ranks,
    and the forward of a model whose wide weights are sharded over a
    ("model": 2) mesh, which `replicate_state` refuses; the results go to
    <out_dir>/rank<r>.pt."""
    torch.set_num_threads(1)
    register_droppath_variant()
    pm.init_rank(rank, WORLD, "gloo", "cpu", init_method)
    try:
        dp = pm.make_mesh(WORLD)
        out = {"cases": {name: run_case(name, dp) for name in CASES}}
        x, cot = min_on_rank1()
        rows = slice(rank * BATCH // WORLD, (rank + 1) * BATCH // WORLD)
        with collectives.data_group(pm.data_group(dp)):
            out["data_normal_grad"] = data_normal_grad(x[rows], cot[rows])
        cfg, _ = case_config("fixed")
        tp = pm.make_mesh(WORLD, model_parallel=WORLD)
        model = shard_params(noisy_model(cfg.model), tp, min_channels=32)
        out["tp_sharded"] = sorted(k for k, _ in model.named_parameters()
                                   if k.endswith("parametrizations.weight.original"))
        out["tp_forward"] = tp_forward(model)
        refused = []
        for mesh in (tp, dp):       # a "model" axis; weights sliced by shard_params
            try:
                pm.replicate_state(types.SimpleNamespace(model=model), mesh)
            except NotImplementedError as e:
                refused.append(str(e))
        out["tp_replicate_refused"] = refused
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        pm.shutdown()
