"""The training loop: freeze/unfreeze phases, per-epoch LR, val pass,
callbacks, checkpoints (the port's counterpart of `asy_vrnet_tpu/train/loop.py`;
reference train.py:563-622 + utils/utils_fit.py:17-226), on one device or as
one rank of a data-parallel mesh (`parallel/mesh.py`).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from asy_vrnet_tpu_torch.config import Config
from asy_vrnet_tpu_torch.data.dataset import DataLoader, device_prefetch
from asy_vrnet_tpu_torch.parallel.mesh import (
    build_parallel_eval_step,
    build_parallel_train_step,
    replicate_state,
)
from asy_vrnet_tpu_torch.train.callbacks import DetEvalCallback, LossHistory, SegEvalCallback
from asy_vrnet_tpu_torch.train.checkpoint import save_checkpoint, save_weights
from asy_vrnet_tpu_torch.train.optim import make_lr_schedule, set_learning_rate
from asy_vrnet_tpu_torch.train.state import TrainState, eval_variables
from asy_vrnet_tpu_torch.train.train_step import build_eval_step, build_train_step


def _mean_metrics(metric_dicts: list[dict]) -> dict:
    """Epoch-mean of per-step metric dicts (0-d device tensors) with ONE
    device-to-host copy: reading each value as it comes would wait for every
    step and serialise the otherwise asynchronous launches."""
    if not metric_dicts:
        return {}
    keys = list(metric_dicts[0])
    means = torch.stack([torch.stack([m[k].float() for m in metric_dicts]).mean()
                         for k in keys]).cpu()
    return {k: float(v) for k, v in zip(keys, means)}


def fit(
    cfg: Config,
    state: TrainState,
    train_loader: DataLoader,
    val_loader: Optional[DataLoader] = None,
    class_names: Optional[Sequence[str]] = None,
    log: Callable[[str], None] = print,
    mesh=None,
) -> TrainState:
    """Run epochs `cfg.train.init_epoch` .. `cfg.train.epochs` on the device
    the state lies on; returns the state (updated in place).

    With `mesh` (`parallel/mesh.py::make_mesh`) this process is one rank of
    a data-parallel run: the loaders hand out its rows of each global batch
    (`DataLoader(rank=, world=)`), the state is replicated from rank 0 and
    the steps run over the mesh's "data" axis (global losses, metrics and
    gradients).  Rank 0 alone logs, writes the loss history, weights and
    checkpoints, and runs the evaluation callbacks on the whole val set,
    unsharded as in the JAX package; the other ranks wait at a barrier."""
    tcfg = cfg.train
    dev = state.log_var.device
    save_dir = tcfg.save_dir
    lead = mesh is None or dist.get_rank() == 0
    if not lead:
        log = lambda msg: None  # noqa: E731

    loss_history = det_cb = seg_cb = None
    if lead:
        os.makedirs(save_dir, exist_ok=True)
        loss_history = LossHistory(os.path.join(save_dir, "loss"), "det_seg")
    if lead and val_loader is not None and class_names is not None:
        cb_loader = val_loader if val_loader.world == 1 else DataLoader(
            val_loader.dataset, val_loader.batch_size, shuffle=False,
            prefetch=val_loader.prefetch, drop_last=val_loader.drop_last,
            workers=val_loader.workers)
        det_cb = DetEvalCallback(
            state.model, cfg, cb_loader, class_names, save_dir,
            period=tcfg.eval_period, conf_thres=tcfg.eval_conf_thres,
            max_det=tcfg.eval_max_det,
        )
        seg_cb = SegEvalCallback(state.model, cfg, cb_loader, save_dir,
                                 period=tcfg.eval_period)

    freeze = tcfg.freeze_epoch > tcfg.init_epoch
    # The reference trains the frozen phase at a larger batch (train.py:90,
    # 568-606 rebuilds loaders and re-derives the adaptive LR at the
    # transition); mirror that with a per-phase loader + schedule.
    schedule = make_lr_schedule(cfg.optim, tcfg.batch_size, tcfg.epochs)
    schedule_frozen = make_lr_schedule(cfg.optim, tcfg.freeze_batch_size, tcfg.epochs)
    frozen_loader = None
    if freeze and tcfg.freeze_batch_size != train_loader.batch_size:
        frozen_loader = DataLoader(
            train_loader.dataset, tcfg.freeze_batch_size,
            shuffle=train_loader.shuffle, prefetch=train_loader.prefetch,
            drop_last=train_loader.drop_last, workers=train_loader.workers,
            rank=train_loader.rank, world=train_loader.world,
        )
    step_frozen = build_train_step(cfg, freeze_backbone=True, device=dev)
    step_unfrozen = build_train_step(cfg, freeze_backbone=False, device=dev)
    ev_step = build_eval_step(cfg, device=dev)
    if mesh is not None:
        step_frozen = build_parallel_train_step(step_frozen, mesh)
        step_unfrozen = build_parallel_train_step(step_unfrozen, mesh)
        ev_step = build_parallel_eval_step(ev_step, mesh)
        replicate_state(state, mesh)

    best_val = float("inf")
    for epoch in range(tcfg.init_epoch, tcfg.epochs):
        frozen = freeze and epoch < tcfg.freeze_epoch
        step_fn = step_frozen if frozen else step_unfrozen
        loader = frozen_loader if (frozen and frozen_loader is not None) else train_loader
        lr = (schedule_frozen if frozen else schedule)(epoch)
        set_learning_rate(state.optimizer, lr)

        t0 = time.time()
        train_metrics = []
        for db in device_prefetch(iter(loader), dev):
            db.pop("image_id", None)
            state, metrics = step_fn(state, db)
            train_metrics.append(metrics)
        tm = _mean_metrics(train_metrics)

        vm = {}
        if val_loader is not None:
            val_metrics = []
            for db in device_prefetch(iter(val_loader), dev):
                db.pop("image_id", None)
                val_metrics.append(ev_step(state, db, use_ema=cfg.optim.ema))
            vm = _mean_metrics(val_metrics)

        log(
            f"epoch {epoch + 1}/{tcfg.epochs} lr={lr:.2e} "
            f"loss={tm.get('loss', float('nan')):.3f} "
            f"det={tm.get('loss_det', float('nan')):.3f} "
            f"seg={tm.get('loss_seg', float('nan')):.3f} "
            f"val={vm.get('loss', float('nan')):.3f} "
            f"f_score={tm.get('f_score', float('nan')):.3f} "
            f"({time.time() - t0:.1f}s{' frozen' if frozen else ''})"
        )
        if not lead:
            dist.barrier()          # rank 0's callbacks and writes
            continue
        loss_history.append_loss(
            epoch + 1, tm.get("loss", float("nan")), vm.get("loss", float("nan"))
        )

        variables = eval_variables(state, use_ema=cfg.optim.ema)
        if det_cb is not None:
            ap = det_cb.on_epoch_end(epoch + 1, variables)
            if ap is not None:
                log(f"  val AP50 = {ap:.4f}")
        if seg_cb is not None:
            miou = seg_cb.on_epoch_end(epoch + 1, variables)
            if miou is not None:
                log(f"  val mIoU = {miou:.4f}")

        # checkpoints: periodic, best (val-loss improvement), last
        if (epoch + 1) % tcfg.save_period == 0 or epoch + 1 == tcfg.epochs:
            save_checkpoint(os.path.join(save_dir, "ckpt"), state, epoch=epoch + 1)
        if vm and vm["loss"] <= best_val:
            best_val = vm["loss"]
            save_weights(os.path.join(save_dir, "best_epoch_weights.npz"), variables)
        save_weights(os.path.join(save_dir, "last_epoch_weights.npz"), variables)
        if mesh is not None:
            dist.barrier()
    if lead:
        loss_history.close()
    return state
