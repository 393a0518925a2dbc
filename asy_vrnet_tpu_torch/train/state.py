"""Training state: model + optimiser + EMA + counters (counterpart of
`asy_vrnet_tpu/train/state.py`).

The JAX state is an immutable pytree; here the state owns mutable objects
(the `nn.Module`, the `torch.optim` optimiser, the EMA tensors) and the train
step updates them in place.  The EMA covers parameters *and* BatchNorm
running statistics, keyed by state_dict name.
"""
from __future__ import annotations

import dataclasses

import torch

from asy_vrnet_tpu_torch.config import Config
from asy_vrnet_tpu_torch.models.efficient_vrnet import EfficientVRNet, create_model
from asy_vrnet_tpu_torch.train.optim import ema_decay_schedule, ema_update, make_optimizer
from asy_vrnet_tpu_torch.utils.device import resolve_device, same_device


@dataclasses.dataclass
class TrainState:
    model: EfficientVRNet
    optimizer: torch.optim.Optimizer
    # multitask uncertainty log-variance (utils/multitaskloss.py:10): a
    # persistently learned scalar, updated by plain SGD outside the optimiser
    log_var: torch.Tensor
    ema: dict[str, torch.Tensor]    # EMA of parameters and BN running stats
    ema_updates: float = 0.0        # EMA update counter (ModelEMA.updates)
    step: int = 0


def float_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters and float buffers by state_dict key (views of
    the live tensors; `num_batches_tracked` is left out)."""
    return {k: v for k, v in model.state_dict().items() if v.is_floating_point()}


def create_train_state(cfg: Config, model: EfficientVRNet | None = None,
                       device: str | torch.device | None = None,
                       weights: str | None = None) -> TrainState:
    """Build the state on `device` (default: the card; raises without one).
    `model` defaults to a new `create_model(cfg.model)`, optionally loading a
    weights-only npz; a given model must already live on `device`."""
    dev = resolve_device(device)
    if model is None:
        model = create_model(cfg.model, dev, weights)
    elif not same_device(next(model.parameters()).device, dev):
        raise ValueError(f"model lies on {next(model.parameters()).device}, "
                         f"the train state was asked for {dev}")
    optimizer = make_optimizer(cfg.optim, model.named_parameters())
    return TrainState(
        model=model,
        optimizer=optimizer,
        log_var=torch.zeros((), dtype=torch.float32, device=dev, requires_grad=True),
        ema={k: v.detach().clone() for k, v in float_state(model).items()},
    )


def apply_ema(state: TrainState, ema_decay: float, ema_tau: float) -> None:
    """One ramped EMA update, d = decay * (1 - exp(-updates / tau)), of
    parameters and BN running stats; in place."""
    state.ema_updates += 1.0
    d = ema_decay_schedule(state.ema_updates, ema_decay, ema_tau)
    ema_update(state.ema, float_state(state.model), d)


def eval_variables(state: TrainState, use_ema: bool = True) -> dict[str, torch.Tensor]:
    """Parameters and BN stats for evaluation by state_dict key (the EMA copy
    preferred, like utils/utils_fit.py:139-142)."""
    return dict(state.ema) if use_ema else float_state(state.model)
