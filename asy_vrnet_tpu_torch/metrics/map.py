"""Detection mAP: VOC all-point AP and COCO-style AP (no pycocotools); the
port's own copy of `asy_vrnet_tpu/metrics/map.py`, pure numpy.

The reference computes COCO AP50 through pycocotools with a VOC fallback
(utils/callbacks.py:223-226, utils/utils_map.py:276,894).  This module
implements both natively:

  - `voc_ap`: the VOC2012 all-point interpolation (utils_map.py:95-140);
  - `coco_ap`: 101-point recall interpolation, maxDets cap, score-sorted —
    the COCOeval AP@[.5] protocol for bbox, area=all;
  - an in-memory evaluator (`DetectionEvaluator`) fed with per-image arrays,
    plus reference-format txt-dir reading for the CLI path.
"""
from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOC2012 all-point AP (monotone precision envelope, recall steps)."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def coco_ap_from_pr(rec: np.ndarray, prec: np.ndarray) -> float:
    """COCO 101-point interpolated AP from a PR curve."""
    if len(rec) == 0:
        return 0.0
    mpre = prec.copy()
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    recall_thrs = np.linspace(0.0, 1.0, 101)
    inds = np.searchsorted(rec, recall_thrs, side="left")
    q = np.zeros(101)
    valid = inds < len(mpre)
    q[valid] = mpre[inds[valid]]
    return float(np.mean(q))


def log_average_miss_rate(precision: np.ndarray, fp_cumsum: np.ndarray,
                          num_images: int) -> tuple[float, np.ndarray, np.ndarray]:
    """LAMR over 9 FPPI points in [1e-2, 1e0] (utils_map.py:30-66).

    Returns (lamr, miss_rate, fppi)."""
    if precision.size == 0:
        return 0.0, np.asarray(1.0), np.asarray(0.0)
    fppi = fp_cumsum / float(num_images)
    mr = 1.0 - precision
    fppi_tmp = np.insert(fppi, 0, -1.0)
    mr_tmp = np.insert(mr, 0, 1.0)
    ref = np.logspace(-2.0, 0.0, num=9)
    for i, ref_i in enumerate(ref):
        j = np.where(fppi_tmp <= ref_i)[0][-1]
        ref[i] = mr_tmp[j]
    lamr = float(np.exp(np.mean(np.log(np.maximum(1e-10, ref)))))
    return lamr, mr, fppi


def _iou_matrix(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(D,4)x(G,4) xyxy IoU."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    tl = np.maximum(det[:, None, :2], gt[None, :, :2])
    br = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area_d = np.prod(det[:, 2:] - det[:, :2], axis=-1)
    area_g = np.prod(gt[:, 2:] - gt[:, :2], axis=-1)
    return inter / np.maximum(area_d[:, None] + area_g[None, :] - inter, 1e-12)


class DetectionEvaluator:
    """Accumulates per-image detections and GT; computes AP per class.

    Matching happens at evaluate() time with method-faithful semantics:
      - 'voc' : the classic VOC protocol (utils_map.py get_map): each
        detection takes the global argmax-IoU GT and is a FP if that GT is
        already matched — even when another unmatched GT also overlaps.
      - 'coco': the pycocotools COCOeval protocol: each detection matches the
        *unmatched* GT with the highest IoU >= threshold.
    Each GT is matched at most once under both.
    """

    def __init__(self, class_names: Sequence[str], iou_threshold: float = 0.5,
                 max_dets: int = 100):
        self.class_names = list(class_names)
        self.iou_threshold = iou_threshold
        self.max_dets = max_dets
        # raw per-image records; matching is deferred to evaluate()
        self._images: list[tuple] = []

    def add_image(
        self,
        det_boxes: np.ndarray,     # (D, 4) xyxy
        det_scores: np.ndarray,    # (D,)
        det_classes: np.ndarray,   # (D,) int
        gt_boxes: np.ndarray,      # (G, 4) xyxy
        gt_classes: np.ndarray,    # (G,) int
        gt_difficult: Optional[np.ndarray] = None,
    ) -> None:
        det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        det_scores = np.asarray(det_scores, np.float64).reshape(-1)
        det_classes = np.asarray(det_classes).reshape(-1)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_classes = np.asarray(gt_classes).reshape(-1)
        if gt_difficult is None:
            gt_difficult = np.zeros(len(gt_boxes), bool)

        if len(det_boxes) > self.max_dets:
            keep = np.argsort(-det_scores, kind="stable")[: self.max_dets]
            det_boxes, det_scores, det_classes = (
                det_boxes[keep], det_scores[keep], det_classes[keep]
            )
        self._images.append(
            (det_boxes, det_scores, det_classes, gt_boxes, gt_classes,
             np.asarray(gt_difficult, bool))
        )

    @property
    def _num_images(self) -> int:
        return len(self._images)

    def _match_class(self, c: int, method: str):
        """-> (scores, tps, num_gt) for class c across all images."""
        all_scores, all_tps, num_gt = [], [], 0
        for det_boxes, det_scores, det_classes, gt_boxes, gt_classes, gt_diff \
                in self._images:
            gsel = gt_classes == c
            gboxes = gt_boxes[gsel]
            gdiff = gt_diff[gsel]
            num_gt += int((~gdiff).sum())

            dsel = det_classes == c
            dboxes = det_boxes[dsel]
            dscores = det_scores[dsel]
            order = np.argsort(-dscores, kind="stable")
            dboxes, dscores = dboxes[order], dscores[order]

            iou = _iou_matrix(dboxes, gboxes)
            matched = np.zeros(len(gboxes), bool)
            for d in range(len(dboxes)):
                tp = False
                skip = False
                if len(gboxes):
                    if method == "coco":
                        # pycocotools: best IoU among UNMATCHED gts, >= thr
                        cand = np.where(~matched)[0]
                        if len(cand):
                            best = cand[int(np.argmax(iou[d, cand]))]
                            if iou[d, best] >= self.iou_threshold:
                                if gdiff[best]:
                                    skip = True  # ignored GT absorbs the det
                                else:
                                    matched[best] = True
                                    tp = True
                    else:
                        # VOC: global argmax; FP if that GT is taken
                        best = int(np.argmax(iou[d]))
                        if iou[d, best] >= self.iou_threshold:
                            if gdiff[best]:
                                skip = True
                            elif not matched[best]:
                                matched[best] = True
                                tp = True
                if skip:
                    continue
                all_scores.append(dscores[d])
                all_tps.append(tp)
        return np.asarray(all_scores), np.asarray(all_tps, bool), num_gt

    def evaluate(self, method: str = "coco") -> dict:
        """Per-class AP + mean; method 'coco' (101-pt) or 'voc' (all-point).

        Also returns `curves`: per class, the score-sorted PR arrays plus F1
        and LAMR — the data behind the reference's per-class plot artifacts
        (utils_map.py:30-290), consumable by metrics/plots.py."""
        aps = {}
        curves = {}
        empty = dict(
            scores=np.zeros(0), recall=np.zeros(0), precision=np.zeros(0),
            f1=np.zeros(0), lamr=0.0, num_gt=0, num_det=0,
        )
        for c, name in enumerate(self.class_names):
            scores, tps, n_gt = self._match_class(c, method)
            if n_gt == 0:
                aps[name] = float("nan")
                curves[name] = dict(empty, num_det=len(scores))
                continue
            if len(scores) == 0:
                aps[name] = 0.0
                curves[name] = dict(empty, num_gt=n_gt)
                continue
            order = np.argsort(-scores, kind="stable")
            scores = scores[order]
            tps = tps[order]
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(~tps)
            rec = tp_cum / n_gt
            prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            if method == "voc":
                aps[name] = voc_ap(rec, prec)
            else:
                aps[name] = coco_ap_from_pr(rec, prec)
            lamr, _, _ = log_average_miss_rate(
                prec, fp_cum.astype(np.float64), max(self._num_images, 1)
            )
            curves[name] = dict(
                scores=scores, recall=rec, precision=prec,
                f1=2 * rec * prec / np.maximum(rec + prec, 1e-12),
                lamr=lamr, num_gt=n_gt, num_det=len(scores),
            )
        valid = [v for v in aps.values() if not np.isnan(v)]
        return {
            "ap_per_class": aps,
            "map": float(np.mean(valid)) if valid else 0.0,
            "curves": curves,
            "num_images": self._num_images,
        }


# ---------------------------------------------------------------------------
# Reference txt-format compatibility (utils/utils_map.py get_map pipeline):
#   ground-truth/<id>.txt : "<class> <x1> <y1> <x2> <y2> [difficult]"
#   detection-results/<id>.txt : "<class> <score> <x1> <y1> <x2> <y2>"
# ---------------------------------------------------------------------------

def evaluate_txt_dirs(
    path: str,
    class_names: Sequence[str],
    iou_threshold: float = 0.5,
    method: str = "coco",
) -> dict:
    gt_dir = os.path.join(path, "ground-truth")
    dr_dir = os.path.join(path, "detection-results")
    name_to_idx = {n: i for i, n in enumerate(class_names)}
    ev = DetectionEvaluator(class_names, iou_threshold)
    for gt_file in sorted(glob.glob(os.path.join(gt_dir, "*.txt"))):
        image_id = os.path.splitext(os.path.basename(gt_file))[0]
        gts, gcls, gdiff = [], [], []
        with open(gt_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                difficult = parts[-1] == "difficult"
                if difficult:
                    parts = parts[:-1]
                cname = " ".join(parts[:-4])
                if cname not in name_to_idx:
                    continue
                gts.append([float(v) for v in parts[-4:]])
                gcls.append(name_to_idx[cname])
                gdiff.append(difficult)
        dets, dscore, dcls = [], [], []
        dr_file = os.path.join(dr_dir, image_id + ".txt")
        if os.path.exists(dr_file):
            with open(dr_file) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    cname = " ".join(parts[:-5])
                    if cname not in name_to_idx:
                        continue
                    dscore.append(float(parts[-5]))
                    dets.append([float(v) for v in parts[-4:]])
                    dcls.append(name_to_idx[cname])
        ev.add_image(
            np.array(dets).reshape(-1, 4), np.array(dscore), np.array(dcls),
            np.array(gts).reshape(-1, 4), np.array(gcls),
            np.array(gdiff, bool) if gdiff else None,
        )
    return ev.evaluate(method)
