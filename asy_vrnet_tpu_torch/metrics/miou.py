"""Segmentation metrics: confusion-matrix mIoU/PA/precision/recall; the port's
own copy of `asy_vrnet_tpu/metrics/miou.py`, pure numpy.

Parity with utils_seg/utils_metrics.py:34-193 (fast_hist, per_class_iu,
per_class_PA_Recall, per_class_Precision, compute_mIoU).  Array-based core
plus the reference's PNG-directory entry point.
"""
from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

import numpy as np


def fast_hist(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Confusion matrix between label map a and prediction map b, both flat."""
    k = (a >= 0) & (a < n)
    return np.bincount(n * a[k].astype(int) + b[k], minlength=n**2).reshape(n, n)


def per_class_iu(hist: np.ndarray) -> np.ndarray:
    return np.diag(hist) / np.maximum(
        hist.sum(1) + hist.sum(0) - np.diag(hist), 1
    )


def per_class_pa_recall(hist: np.ndarray) -> np.ndarray:
    return np.diag(hist) / np.maximum(hist.sum(1), 1)


def per_class_precision(hist: np.ndarray) -> np.ndarray:
    return np.diag(hist) / np.maximum(hist.sum(0), 1)


def per_accuracy(hist: np.ndarray) -> float:
    return float(np.diag(hist).sum() / np.maximum(hist.sum(), 1))


class MIoUAccumulator:
    """Streaming confusion-matrix accumulator over host label maps."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.hist = np.zeros((num_classes, num_classes), np.int64)

    def update(self, label: np.ndarray, pred: np.ndarray) -> None:
        self.hist += fast_hist(
            np.asarray(label).flatten(), np.asarray(pred).flatten(), self.num_classes
        )

    def result(self) -> dict:
        ious = per_class_iu(self.hist)
        pa = per_class_pa_recall(self.hist)
        prec = per_class_precision(self.hist)
        return {
            "miou": float(np.nanmean(ious)),
            "mpa": float(np.nanmean(pa)),
            "accuracy": per_accuracy(self.hist),
            "iou_per_class": ious,
            "recall_per_class": pa,
            "precision_per_class": prec,
        }


def compute_miou_dirs(
    gt_dir: str,
    pred_dir: str,
    image_ids: Sequence[str],
    num_classes: int,
    name_classes: Optional[Sequence[str]] = None,
    verbose: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """PNG-directory mIoU (compute_mIoU, utils_seg/utils_metrics.py:63-134).

    Returns (hist, IoUs, PA_Recall, Precision).

    NOTE on console output: the progress / per-class lines below reproduce the
    reference's print format (utils_seg/utils_metrics.py:104-135) VERBATIM by
    design — downstream tooling that scrapes the reference's "===>" summary
    lines keeps working unchanged.  This is intentional output-format parity,
    not code reuse; the computation above is an independent numpy
    implementation.
    """
    from PIL import Image

    hist = np.zeros((num_classes, num_classes), np.int64)
    for ind, image_id in enumerate(image_ids):
        pred = np.array(Image.open(os.path.join(pred_dir, image_id + ".png")))
        label = np.array(Image.open(os.path.join(gt_dir, image_id + ".png")))
        if len(label.flatten()) != len(pred.flatten()):
            if verbose:
                print(
                    f"Skipping: len(gt) = {len(label.flatten())}, "
                    f"len(pred) = {len(pred.flatten())}, {image_id}"
                )
            continue
        hist += fast_hist(label.flatten(), pred.flatten(), num_classes)
        if verbose and name_classes is not None and ind > 0 and ind % 10 == 0:
            print(
                "{:d} / {:d}: mIou-{:0.2f}%; mPA-{:0.2f}%; Accuracy-{:0.2f}%".format(
                    ind, len(image_ids),
                    100 * np.nanmean(per_class_iu(hist)),
                    100 * np.nanmean(per_class_pa_recall(hist)),
                    100 * per_accuracy(hist),
                )
            )
    ious = per_class_iu(hist)
    pa = per_class_pa_recall(hist)
    precision = per_class_precision(hist)
    if verbose and name_classes is not None:
        for i in range(num_classes):
            print(
                "===>"
                + name_classes[i]
                + ":\tIou-" + str(round(ious[i] * 100, 2))
                + "; Recall-" + str(round(pa[i] * 100, 2))
                + "; Precision-" + str(round(precision[i] * 100, 2))
            )
        print(
            "===> mIoU: " + str(round(np.nanmean(ious) * 100, 2))
            + "; mPA: " + str(round(np.nanmean(pa) * 100, 2))
            + "; Accuracy: " + str(round(per_accuracy(hist) * 100, 2))
        )
    return hist, ious, pa, precision


def save_results(
    out_dir: str,
    hist: np.ndarray,
    ious: np.ndarray,
    pa_recall: np.ndarray,
    precision: np.ndarray,
    name_classes: Sequence[str],
) -> None:
    """CSV + PNG outputs equivalent to show_results
    (utils_seg/utils_metrics.py:169-193): confusion matrix / metrics CSVs plus
    mIoU/mPA/Recall/Precision bar plots (PNGs skipped without matplotlib)."""
    from asy_vrnet_tpu_torch.metrics.plots import plot_miou_results

    os.makedirs(out_dir, exist_ok=True)
    plot_miou_results(out_dir, np.asarray(ious), np.asarray(pa_recall),
                      np.asarray(precision), name_classes)
    with open(os.path.join(out_dir, "confusion_matrix.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([" "] + list(name_classes))
        for i, name in enumerate(name_classes):
            writer.writerow([name] + list(hist[i]))
    with open(os.path.join(out_dir, "metrics.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["class", "iou", "recall", "precision"])
        for i, name in enumerate(name_classes):
            writer.writerow([name, ious[i], pa_recall[i], precision[i]])
        writer.writerow(["mean", np.nanmean(ious), np.nanmean(pa_recall), np.nanmean(precision)])
