"""Matplotlib plot artifacts, optional at runtime (the port's own copy of
`asy_vrnet_tpu/metrics/plots.py`).

The reference's eval story is txt + PNG plots: savgol-smoothed loss curves
(utils/callbacks.py:56-80), epoch AP / mIoU curves (utils/callbacks.py:230-245,
utils_seg/callbacks.py:198-213), per-class AP/F1/PR/LAMR plots
(utils/utils_map.py:30-290) and mIoU/mPA/Recall/Precision bar plots
(utils_seg/utils_metrics.py:169-193).  This module provides equivalents; every
function is a silent no-op when matplotlib is unavailable (mirroring the
TensorBoard-optional pattern in train/callbacks.py).
"""
from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_loss_curves(path: str, losses: Sequence[float],
                     val_losses: Sequence[float]) -> bool:
    """Train/val loss curves with savgol smoothing (utils/callbacks.py:56-80)."""
    plt = _plt()
    if plt is None or not losses:
        return False
    iters = range(len(losses))
    fig = plt.figure()
    plt.plot(iters, losses, "red", linewidth=2, label="train loss")
    plt.plot(iters, val_losses, "coral", linewidth=2, label="val loss")
    try:
        from scipy.signal import savgol_filter

        window = 5 if len(losses) < 25 else 15
        if len(losses) > window:
            plt.plot(iters, savgol_filter(losses, window, 3), "green",
                     linestyle="--", linewidth=2, label="smooth train loss")
            plt.plot(iters, savgol_filter(val_losses, window, 3), "#8B4513",
                     linestyle="--", linewidth=2, label="smooth val loss")
    except Exception:
        pass
    plt.grid(True)
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.legend(loc="upper right")
    fig.savefig(path)
    plt.close(fig)
    return True


def plot_metric_curve(path: str, epochs: Sequence[int], values: Sequence[float],
                      ylabel: str, title: str = "") -> bool:
    """Single metric-vs-epoch curve (epoch_map.png / epoch_miou.png)."""
    plt = _plt()
    if plt is None or not values:
        return False
    fig = plt.figure()
    plt.plot(list(epochs), list(values), "red", linewidth=2, label=ylabel)
    plt.grid(True)
    plt.xlabel("Epoch")
    plt.ylabel(ylabel)
    if title:
        plt.title(title)
    plt.legend(loc="upper right")
    fig.savefig(path)
    plt.close(fig)
    return True


def plot_horizontal_bars(path: str, values: Mapping[str, float], title: str,
                         xlabel: str, fmt: str = "{:.2f}") -> bool:
    """Per-class horizontal bar chart (the utils_map.py:168-290 style used
    for mAP / LAMR / gt counts and the utils_seg results plots)."""
    plt = _plt()
    if plt is None or not values:
        return False
    names = list(values.keys())
    vals = [0.0 if v is None or np.isnan(v) else float(v) for v in values.values()]
    fig, ax = plt.subplots(figsize=(8, max(2.0, 0.5 * len(names) + 1.5)))
    y = np.arange(len(names))
    ax.barh(y, vals, color="royalblue")
    ax.set_yticks(y)
    ax.set_yticklabels(names)
    ax.invert_yaxis()
    ax.set_xlabel(xlabel)
    ax.set_title(title)
    for yi, v in zip(y, vals):
        ax.text(v, yi, " " + fmt.format(v), va="center")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def plot_pr_curve(path: str, recall: np.ndarray, precision: np.ndarray,
                  class_name: str, ap: float) -> bool:
    """Per-class precision-recall curve with AP in the title
    (utils_map.py get_map per-class 'AP' plot)."""
    plt = _plt()
    if plt is None:
        return False
    fig = plt.figure()
    plt.plot(recall, precision, "-o", markersize=2)
    # area-under-curve shading like the reference's fill_between
    plt.fill_between(recall, 0, precision, alpha=0.2, edgecolor="r")
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    plt.title(f"class: {class_name}  AP = {ap * 100:.2f}%")
    plt.xlim(0.0, 1.0)
    plt.ylim(0.0, 1.05)
    plt.grid(True)
    fig.savefig(path)
    plt.close(fig)
    return True


def plot_score_curve(path: str, scores: np.ndarray, values: np.ndarray,
                     class_name: str, ylabel: str) -> bool:
    """Per-class metric-vs-confidence curve (the F1 / Recall / Precision
    plots of utils_map.py get_map)."""
    plt = _plt()
    if plt is None:
        return False
    fig = plt.figure()
    plt.plot(scores, values, "-", linewidth=2)
    plt.xlabel("Score threshold")
    plt.ylabel(ylabel)
    plt.title(f"class: {class_name}  {ylabel}")
    plt.grid(True)
    fig.savefig(path)
    plt.close(fig)
    return True


def plot_detection_report(out_dir: str, result: dict,
                          method_label: str = "AP50") -> list[str]:
    """Full per-class detection report from DetectionEvaluator.evaluate():
    mAP + LAMR + ground-truth bars, and per-class PR / F1 / Recall /
    Precision curves (the utils_map.py:30-290 artifact set).  Returns the
    list of files written (empty when matplotlib is unavailable)."""
    if _plt() is None:
        return []
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def _w(ok: bool, path: str):
        if ok:
            written.append(path)

    p = os.path.join(out_dir, "mAP.png")
    _w(plot_horizontal_bars(
        p, result["ap_per_class"],
        f"mAP = {result['map'] * 100:.2f}%", method_label), p)
    curves = result.get("curves", {})
    if curves:
        lamr = {n: c["lamr"] for n, c in curves.items()}
        p = os.path.join(out_dir, "lamr.png")
        _w(plot_horizontal_bars(p, lamr, "log-average miss rate",
                                "log-average miss rate"), p)
        n_gt = {n: float(c["num_gt"]) for n, c in curves.items()}
        p = os.path.join(out_dir, "ground-truth-info.png")
        _w(plot_horizontal_bars(p, n_gt, "ground-truth objects per class",
                                "count", fmt="{:.0f}"), p)
        for sub in ("AP", "F1", "Recall", "Precision"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        for name, c in curves.items():
            if c["scores"].size == 0:
                continue
            ap = result["ap_per_class"].get(name, 0.0)
            p = os.path.join(out_dir, "AP", f"{name}.png")
            _w(plot_pr_curve(p, c["recall"], c["precision"], name,
                             0.0 if np.isnan(ap) else ap), p)
            for sub, key in (("F1", "f1"), ("Recall", "recall"),
                             ("Precision", "precision")):
                p = os.path.join(out_dir, sub, f"{name}.png")
                _w(plot_score_curve(p, c["scores"], c[key], name, sub), p)
    return written


def plot_miou_results(out_dir: str, ious: np.ndarray, pa_recall: np.ndarray,
                      precision: np.ndarray,
                      name_classes: Sequence[str]) -> list[str]:
    """mIoU / mPA / Recall / Precision bar plots
    (utils_seg/utils_metrics.py:169-193).  Returns files written."""
    if _plt() is None:
        return []
    os.makedirs(out_dir, exist_ok=True)
    written = []
    specs = [
        ("mIoU.png", ious, f"mIoU = {np.nanmean(ious) * 100:.2f}%",
         "Intersection over Union"),
        ("mPA.png", pa_recall, f"mPA = {np.nanmean(pa_recall) * 100:.2f}%",
         "Pixel Accuracy"),
        ("Recall.png", pa_recall, f"mRecall = {np.nanmean(pa_recall) * 100:.2f}%",
         "Recall"),
        ("Precision.png", precision,
         f"mPrecision = {np.nanmean(precision) * 100:.2f}%", "Precision"),
    ]
    for fname, vals, title, xlabel in specs:
        path = os.path.join(out_dir, fname)
        data = {n: float(v) for n, v in zip(name_classes, vals)}
        if plot_horizontal_bars(path, data, title, xlabel):
            written.append(path)
    return written
