"""Training observability: loss history and the periodic mAP / mIoU eval
callbacks (the port's counterpart of `asy_vrnet_tpu/train/callbacks.py`;
reference utils/callbacks.py:21-248 and utils_seg/callbacks.py:22-216).

Evaluation runs batched on the device: forward (with the given variables
through `torch.func.functional_call`, so the live model's weights and BN
state stay as they are), decode and fixed-shape NMS for detection, argmax for
segmentation; one host transfer per batch; the metrics are the in-memory
numpy evaluators of `asy_vrnet_tpu_torch.metrics`.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from asy_vrnet_tpu_torch.config import Config
from asy_vrnet_tpu_torch.data.preprocess import maybe_normalize_image_device
from asy_vrnet_tpu_torch.metrics.map import DetectionEvaluator
from asy_vrnet_tpu_torch.metrics.miou import MIoUAccumulator
from asy_vrnet_tpu_torch.metrics.plots import plot_loss_curves, plot_metric_curve
from asy_vrnet_tpu_torch.ops.boxes import decode_predictions
from asy_vrnet_tpu_torch.ops.nms import non_max_suppression


class LossHistory:
    """txt logs + loss-curve PNG + optional TensorBoard scalars
    (utils/callbacks.py:21-80)."""

    def __init__(self, log_dir: str, tag: str = "loss"):
        self.log_dir = log_dir
        self.tag = tag
        self.losses: list[float] = []
        self.val_loss: list[float] = []
        os.makedirs(log_dir, exist_ok=True)
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(log_dir)
        except ImportError:
            pass

    def append_loss(self, epoch: int, loss: float, val_loss: float) -> None:
        self.losses.append(loss)
        self.val_loss.append(val_loss)
        with open(os.path.join(self.log_dir, f"epoch_{self.tag}.txt"), "a") as f:
            f.write(f"{loss}\n")
        with open(os.path.join(self.log_dir, f"epoch_val_{self.tag}.txt"), "a") as f:
            f.write(f"{val_loss}\n")
        if self.writer is not None:
            self.writer.add_scalar(f"{self.tag}/train", loss, epoch)
            self.writer.add_scalar(f"{self.tag}/val", val_loss, epoch)
        plot_loss_curves(
            os.path.join(self.log_dir, f"epoch_{self.tag}.png"),
            self.losses, self.val_loss,
        )

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


class _EvalForward:
    """The model's eval-mode forward under given variables, on its device."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def __call__(self, variables: Mapping[str, torch.Tensor], batch: dict):
        image = torch.as_tensor(batch["image"]).to(self.device)
        radar = torch.as_tensor(batch["radar"]).to(self.device)
        was_training = self.model.training
        self.model.eval()
        try:
            return torch.func.functional_call(
                self.model, dict(variables), (maybe_normalize_image_device(image), radar))
        finally:
            self.model.train(was_training)


class DetEvalCallback:
    """Periodic COCO-style AP50 on the val split (utils/callbacks.py:83-248).

    Detections and padded GT are compared in network-input coordinates (the
    letterbox is a monotonic affine map, so AP is unchanged)."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: Config,
        val_loader,
        class_names: Sequence[str],
        log_dir: str,
        period: int = 10,
        conf_thres: float = 0.05,
        nms_thres: float = 0.5,
        max_det: int = 100,
    ):
        self.cfg = cfg
        self.val_loader = val_loader
        self.class_names = class_names
        self.log_dir = log_dir
        self.period = max(1, period)
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres
        self.max_det = max_det
        self.maps: list[float] = [0.0]
        self.epochs: list[int] = [0]
        self._forward = _EvalForward(model)
        os.makedirs(log_dir, exist_ok=True)

    def _detect(self, variables, batch) -> np.ndarray:
        """-> (B, max_det, 7) host array: boxes xyxy (normalised), score,
        class, valid; one device-to-host copy."""
        m = self.cfg.model
        det, _ = self._forward(variables, batch)
        out = non_max_suppression(
            decode_predictions(det, m.input_size, m.head_strides), m.num_classes,
            conf_thres=self.conf_thres, nms_thres=self.nms_thres, max_out=self.max_det)
        return torch.cat([out["boxes_xyxy"].float(), out["scores"][..., None].float(),
                          out["classes"][..., None].float(),
                          out["valid"][..., None].float()], -1).cpu().numpy()

    def on_epoch_end(self, epoch: int, variables: Mapping[str, torch.Tensor]
                     ) -> Optional[float]:
        if epoch % self.period != 0:
            return None
        h, w = self.cfg.model.input_size
        scale = np.array([w, h, w, h], np.float32)
        ev = DetectionEvaluator(self.class_names, iou_threshold=0.5)
        for batch in self.val_loader:
            out = self._detect(variables, batch)
            for i in range(len(out)):
                valid = out[i, :, 6] > 0
                gt_valid = batch["gt_valid"][i]
                gt_cxcywh = batch["gt_boxes"][i][gt_valid]
                gt_xyxy = np.concatenate(
                    [gt_cxcywh[:, :2] - gt_cxcywh[:, 2:] / 2,
                     gt_cxcywh[:, :2] + gt_cxcywh[:, 2:] / 2], axis=-1,
                )
                ev.add_image(
                    out[i, valid, :4] * scale, out[i, valid, 4],
                    out[i, valid, 5].astype(np.int64),
                    gt_xyxy, batch["gt_classes"][i][gt_valid],
                )
        res = ev.evaluate(method="coco")
        self.maps.append(res["map"])
        self.epochs.append(epoch)
        with open(os.path.join(self.log_dir, "epoch_map.txt"), "a") as f:
            f.write(f"{res['map']}\n")
        plot_metric_curve(
            os.path.join(self.log_dir, "epoch_map.png"),
            self.epochs, self.maps, "mAP50", "A Map Curve",
        )
        return res["map"]


class SegEvalCallback:
    """Periodic mIoU on the val split (utils_seg/callbacks.py:84-216): argmax
    on the device, the confusion matrix on the host, in the letterboxed
    frame."""

    def __init__(self, model: torch.nn.Module, cfg: Config, val_loader, log_dir: str,
                 period: int = 10):
        self.cfg = cfg
        self.val_loader = val_loader
        self.log_dir = log_dir
        self.period = max(1, period)
        self.mious: list[float] = [0.0]
        self.epochs: list[int] = [0]
        self._forward = _EvalForward(model)
        os.makedirs(log_dir, exist_ok=True)

    def on_epoch_end(self, epoch: int, variables: Mapping[str, torch.Tensor]
                     ) -> Optional[float]:
        if epoch % self.period != 0:
            return None
        n = self.cfg.model.num_seg_classes
        # class indices cross to the host as uint8 where they fit (8x fewer
        # bytes than argmax's int64)
        small = torch.uint8 if n <= 256 else torch.int64
        acc = MIoUAccumulator(n)
        for batch in self.val_loader:
            _, seg = self._forward(variables, batch)
            acc.update(batch["seg_target"], torch.argmax(seg, dim=-1).to(small).cpu().numpy())
        res = acc.result()
        self.mious.append(res["miou"])
        self.epochs.append(epoch)
        with open(os.path.join(self.log_dir, "epoch_miou.txt"), "a") as f:
            f.write(f"{res['miou']}\n")
        plot_metric_curve(
            os.path.join(self.log_dir, "epoch_miou.png"),
            self.epochs, self.mious, "Miou", "A Miou Curve",
        )
        return res["miou"]
