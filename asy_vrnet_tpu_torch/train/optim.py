"""Optimiser, LR schedules, EMA (counterpart of `asy_vrnet_tpu/train/optim.py`;
reference train.py:448-478, nets/yolo_training.py:449-536).

Parameter grouping mirrors the reference's pg0/pg1/pg2 split: weight decay
applies only to conv kernels; BN/GroupNorm scales, biases and scalar
parameters are decay-free.  The JAX package's chain (add weight_decay*param
to the gradient of the decayed leaves, then momentum-nesterov or Adam, then
scale by -lr) is what `torch.optim.SGD` / `torch.optim.Adam` compute with two
parameter groups, so those are used; the parity tests hold them to the optax
chain.  The learning rate is set from outside each epoch
(`set_learning_rate`), like set_optimizer_lr (yolo_training.py:539-542).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from asy_vrnet_tpu_torch.config import OptimConfig

# ShuffleAttention gate parameters are (C,) vectors in the JAX package and
# (1,C,1,1) here: decay-free in both, whatever their torch ndim says.
_VECTOR_LEAVES = ("cweight", "cbias", "sweight", "sbias")


def adaptive_lr(cfg: OptimConfig, batch_size: int) -> tuple[float, float]:
    """Batch-size-adaptive init/min lr with optimiser clamps (train.py:451-455)."""
    if cfg.optimizer == "adam":
        lr_max, lr_min = 1e-3, 3e-4
    else:
        lr_max, lr_min = 5e-2, 5e-4
    init_lr = min(max(batch_size / cfg.nbs * cfg.init_lr, lr_min), lr_max)
    min_lr_target = cfg.init_lr * cfg.min_lr_ratio
    min_lr = min(
        max(batch_size / cfg.nbs * min_lr_target, lr_min * 1e-2), lr_max * 1e-2
    )
    return init_lr, min_lr


def yolox_warm_cos_lr(
    lr: float, min_lr: float, total_iters: int,
    warmup_iters_ratio: float = 0.05, warmup_lr_ratio: float = 0.1,
    no_aug_iter_ratio: float = 0.05,
) -> Callable[[float], float]:
    """Quadratic-warmup cosine schedule (yolo_training.py:506-517,526-530)."""
    warmup_total = min(max(warmup_iters_ratio * total_iters, 1), 3)
    warmup_start = max(warmup_lr_ratio * lr, 1e-6)
    no_aug = min(max(no_aug_iter_ratio * total_iters, 1), 15)

    def f(iters: float) -> float:
        if iters <= warmup_total:
            return (lr - warmup_start) * (iters / warmup_total) ** 2 + warmup_start
        if iters >= total_iters - no_aug:
            return min_lr
        return min_lr + 0.5 * (lr - min_lr) * (
            1.0 + math.cos(
                math.pi * (iters - warmup_total) / (total_iters - warmup_total - no_aug)
            )
        )

    return f


def step_lr(lr: float, min_lr: float, total_iters: int, step_num: int = 10
            ) -> Callable[[float], float]:
    """Step decay (yolo_training.py:519-524,531-534)."""
    decay_rate = (min_lr / lr) ** (1 / (step_num - 1))
    step_size = total_iters / step_num

    def f(iters: float) -> float:
        return lr * decay_rate ** (iters // step_size)

    return f


def make_lr_schedule(cfg: OptimConfig, batch_size: int, total_epochs: int
                     ) -> Callable[[float], float]:
    init_lr, min_lr = adaptive_lr(cfg, batch_size)
    if cfg.lr_decay_type == "cos":
        return yolox_warm_cos_lr(
            init_lr, min_lr, total_epochs,
            cfg.warmup_iters_ratio, cfg.warmup_lr_ratio, cfg.no_aug_iter_ratio,
        )
    return step_lr(init_lr, min_lr, total_epochs, cfg.step_num)


def decays(name: str, param: torch.Tensor) -> bool:
    """True for parameters that receive weight decay: the leaves with
    ndim >= 2 in the JAX package (conv kernels, ECA's 1-D conv)."""
    return param.ndim >= 2 and name.rsplit(".", 1)[-1] not in _VECTOR_LEAVES


def make_optimizer(cfg: OptimConfig,
                   named_params: Iterable[tuple[str, torch.Tensor]]
                   ) -> torch.optim.Optimizer:
    """SGD-nesterov / Adam over two groups (decayed, decay-free), with the
    learning rate left to `set_learning_rate` (1e-3 until then)."""
    named = list(named_params)
    groups = [
        {"params": [p for n, p in named if decays(n, p)],
         "weight_decay": cfg.weight_decay},
        {"params": [p for n, p in named if not decays(n, p)], "weight_decay": 0.0},
    ]
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(groups, lr=1e-3, momentum=cfg.momentum,
                               nesterov=cfg.nesterov)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(groups, lr=1e-3, betas=(cfg.momentum, 0.999), eps=1e-8)
    raise ValueError(cfg.optimizer)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def ema_decay_schedule(updates: float, decay: float = 0.9999,
                       tau: float = 2000.0) -> float:
    """Ramped EMA decay d(t) = decay*(1-exp(-t/tau)) (yolo_training.py:461)."""
    return decay * (1.0 - math.exp(-updates / tau))


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], new: dict[str, torch.Tensor],
               d: float) -> None:
    """v_ema = d*v_ema + (1-d)*v for every float entry, in place (integer
    entries are copied; yolo_training.py:465-475).  One fused multi-tensor
    call per step, whatever the number of entries."""
    floats = [k for k, v in ema.items() if v.is_floating_point()]
    if floats:
        mine = [ema[k] for k in floats]
        torch._foreach_mul_(mine, d)
        torch._foreach_add_(mine, [new[k].detach() for k in floats], alpha=1.0 - d)
    for k, v in ema.items():
        if not v.is_floating_point():
            v.copy_(new[k])
