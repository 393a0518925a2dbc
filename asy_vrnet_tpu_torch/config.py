"""Typed configuration tree for the PyTorch port (own copy).

The same dataclasses, defaults and JSON round trip as the JAX package's
`asy_vrnet_tpu/config.py`, so one config file drives both packages.  The port
keeps its own copy and never imports the JAX package.  Fields that only steer
the TPU build (`use_pallas_cluster`'s Pallas wording, `prestem_s2d`,
`train_remat`) are kept for the round trip; the port's model reads
`use_pallas_cluster` as "use the fused ClusterBlock kernels" and always takes
the literal pre-stem entry.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


# phi -> (depth, width) scaling table, mirroring nets/efficient_vrnet.py:16-17.
DEPTH_TABLE = {"nano": 0.33, "tiny": 0.33, "s": 0.33, "m": 0.67, "l": 1.00}
WIDTH_TABLE = {"nano": 0.25, "tiny": 0.375, "s": 0.50, "m": 0.75, "l": 1.00}


@dataclass(frozen=True)
class CoCVariant:
    """A Context-Cluster backbone variant (vr_coc.py:707-808 registry)."""

    layers: tuple[int, ...] = (2, 2, 6, 2)
    embed_dims: tuple[int, ...] = (64, 128, 320, 512)
    mlp_ratios: tuple[float, ...] = (8, 8, 4, 4)
    downsamples: tuple[bool, ...] = (True, True, True, True)
    proposal_w: tuple[int, ...] = (2, 2, 2, 2)
    proposal_h: tuple[int, ...] = (2, 2, 2, 2)
    fold_w: tuple[int, ...] = (8, 4, 2, 1)
    fold_h: tuple[int, ...] = (8, 4, 2, 1)
    heads: tuple[int, ...] = (4, 4, 8, 8)
    head_dim: tuple[int, ...] = (32, 32, 32, 32)
    down_patch_size: int = 3
    down_pad: int = 1
    in_patch_size: int = 4
    in_stride: int = 4
    in_pad: int = 0
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    use_layer_scale: bool = True
    layer_scale_init_value: float = 1e-5

    def scaled_dims(self, width: float) -> tuple[int, ...]:
        return tuple(int(d * width) for d in self.embed_dims)


# Registry of backbone variants (parity with vr_coc.py:707-808).
COC_VARIANTS: dict[str, CoCVariant] = {
    "coc_small": CoCVariant(),
    "coc_medium": CoCVariant(layers=(4, 4, 12, 4), heads=(6, 6, 12, 12)),
    "coc_tiny": CoCVariant(
        layers=(3, 4, 5, 2),
        embed_dims=(32, 64, 196, 320),
        head_dim=(24, 24, 24, 24),
    ),
    "coc_tiny2": CoCVariant(
        layers=(3, 4, 5, 2),
        embed_dims=(32, 64, 196, 320),
        proposal_w=(4, 2, 7, 4),
        proposal_h=(4, 2, 7, 4),
        fold_w=(8, 8, 1, 1),
        fold_h=(8, 8, 1, 1),
        head_dim=(24, 24, 24, 24),
    ),
    # 1-block-per-stage coc_small: exercises every architectural element
    # (all 4 stage shapes, fusions, neck CoC blocks) at minimum depth — used
    # by the multichip dry run to compose the full Pallas production step
    # under GSPMD in CPU interpret mode without blowing the rendezvous budget.
    "coc_dryrun": CoCVariant(layers=(1, 1, 1, 1)),
}


@dataclass(frozen=True)
class ModelConfig:
    """EfficientVRNet assembly config (nets/efficient_vrnet.py:13-27)."""

    num_classes: int = 4
    num_seg_classes: int = 9
    phi: str = "nano"
    variant: str = "coc_small"
    input_size: tuple[int, int] = (512, 512)
    image_channels: int = 3
    radar_channels: int = 4
    head_width: int = 256          # decoupled-head hidden width before scaling
    head_strides: tuple[int, ...] = (8, 16, 32)
    # Compute dtype: "bfloat16" for TPU speed, "float32" for parity checks.
    compute_dtype: str = "bfloat16"
    # Use the fused Pallas cluster kernel where supported.
    use_pallas_cluster: bool = True
    # Space-to-depth pre-stem: run the 512^2 3-7-channel input stage folded
    # to (H/4, W/4, 16C) — exact math in a TPU-friendly layout (the
    # full-resolution layout costs ~20 ms/fwd of lane-padded copies at
    # bs=64).  Identical parameters; disable for bit-level fp32 parity runs.
    prestem_s2d: bool = True
    # parity: the reference's seg head emits post-ReLU "logits"
    # (coc_fpn_dual.py:15-26,164), which hard-clamps the background logit at
    # 0 so it cannot out-compete object-logit bleed at upsampled boundaries
    # (systematic halo dilation; measured mIoU plateau ~0.6-0.7 on an
    # overfit set whose oracle mIoU is 0.99).  True = corrected variant:
    # drop only that final ReLU.  Params identical either way, so weights
    # are interchangeable.
    seg_signed_logits: bool = False
    # Activation rematerialisation for training (trades ~1 extra forward of
    # the wrapped spans for not storing their internals; the reference's
    # fp16-AMP envelope trains at batch 16-32, train.py:86-90 — remat is how
    # the TPU build fits batch 128 in 16G HBM):
    #   "none"   — store everything (fastest bwd, highest memory)
    #   "fusion" — remat stems + the per-stage fusion/enhance modules (the
    #              512^2 pre-stem activations dominate training memory)
    #   "blocks" — "fusion" plus each ClusterBlock individually: stores one
    #              activation per block (its input) instead of two (the
    #              mixer-half and MLP-half inputs), recomputing only the
    #              mixer forward kernel in the backward — the selective
    #              policy for large per-chip batches (VERDICT r3 #4)
    #   "stages" — "fusion" plus every backbone stage's ClusterBlock stack
    #              as one span (lowest memory, recomputes stage convs too)
    train_remat: str = "none"

    @property
    def width(self) -> float:
        return WIDTH_TABLE[self.phi]

    @property
    def depth(self) -> float:
        return DEPTH_TABLE[self.phi]

    @property
    def coc(self) -> CoCVariant:
        return COC_VARIANTS[self.variant]


@dataclass(frozen=True)
class LossConfig:
    """Multi-task loss knobs (utils/utils_fit.py + nets/*_training.py)."""

    focal_loss: bool = True             # focal vs plain CE for segmentation
    dice_loss: bool = True
    focal_alpha: float = 0.5
    focal_gamma: float = 2.0
    # 'fixed': total = det + seg_weight * seg   (utils/utils_fit.py:106)
    # 'uncertainty': Kendall log-var weighting (utils/multitaskloss.py:6-18),
    #   implemented *correctly* here (persistent learned log-var; the
    #   reference re-instantiates the wrapper per step so it never trains).
    multitask_mode: str = "fixed"
    seg_weight: float = 5.0
    # SimOTA / YOLOX loss
    max_boxes: int = 100                # static padding of per-image GT boxes
    center_radius: float = 2.5
    simota_candidate_k: int = 10
    iou_weight: float = 1.0
    obj_weight: float = 2.0
    cls_weight: float = 2.0
    cls_balance_weights: tuple[float, ...] | None = None  # per-seg-class CE weights
    # fused Pallas seg-loss+f_score kernel (ops/losses_seg_pallas.py):
    # None = auto (TPU only), True/False force.  Same math as the jnp oracle.
    use_pallas_seg: bool | None = None


@dataclass(frozen=True)
class OptimConfig:
    """Optimiser / schedule (train.py:148-199,451-473)."""

    optimizer: str = "sgd"              # 'sgd' | 'adam'
    init_lr: float = 1e-2
    min_lr_ratio: float = 0.01
    momentum: float = 0.937
    nesterov: bool = True
    weight_decay: float = 5e-4
    lr_decay_type: str = "cos"          # 'cos' | 'step'
    warmup_iters_ratio: float = 0.05
    warmup_lr_ratio: float = 0.1
    no_aug_iter_ratio: float = 0.05
    step_num: int = 10
    # lr is scaled by batch/nbs with optimiser-dependent clamps (train.py:451-455)
    nbs: int = 64
    ema: bool = True
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 100
    init_epoch: int = 0
    freeze_epoch: int = 0               # backbone-freeze phase length
    freeze_batch_size: int = 32
    batch_size: int = 16
    save_period: int = 10
    eval_period: int = 10
    eval_conf_thres: float = 0.05
    eval_max_det: int = 100
    num_workers: int = 2
    seed: int = 0
    save_dir: str = "logs"
    # data-parallel mesh size; 1 = single chip
    num_devices: int = 1


@dataclass(frozen=True)
class DataConfig:
    train_annotation_path: str = "2007_train.txt"
    val_annotation_path: str = "2007_val.txt"
    classes_path: str = "model_data/waterscenes.txt"
    radar_root: str = "radar"
    seg_dataset_path: str = "."
    input_shape: tuple[int, int] = (512, 512)
    # The reference does NOT min-max normalise radar during training
    # (utils/dataloader.py:87) but does in yolo.detect_image (yolo.py:134).
    # 'none' reproduces training behaviour; 'minmax' the detect path.
    radar_norm: str = "none"
    letterbox: bool = True


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Config":
        def _mk(cls, sub):
            if sub is None:
                return cls()
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kw = {}
            for k, v in sub.items():
                if k not in fields:
                    continue
                if isinstance(v, list):
                    v = tuple(v)
                kw[k] = v
            return cls(**kw)

        return Config(
            model=_mk(ModelConfig, d.get("model")),
            loss=_mk(LossConfig, d.get("loss")),
            optim=_mk(OptimConfig, d.get("optim")),
            train=_mk(TrainConfig, d.get("train")),
            data=_mk(DataConfig, d.get("data")),
        )

    @staticmethod
    def from_json(s: str) -> "Config":
        return Config.from_dict(json.loads(s))


def show_config(cfg: Config) -> str:
    """Tabular config dump, equivalent of utils/utils.py:62-69."""
    lines = ["Configurations:", "-" * 72]
    for section_name in ("model", "loss", "optim", "train", "data"):
        section = getattr(cfg, section_name)
        for f in dataclasses.fields(section):
            key = f"{section_name}.{f.name}"
            lines.append("|%30s | %36s|" % (key, str(getattr(section, f.name))[:36]))
    lines.append("-" * 72)
    return "\n".join(lines)
