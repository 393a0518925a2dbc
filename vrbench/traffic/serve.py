"""Closed-loop serving: one client sends a request of `batch` synchronised
camera + radar frames, waits for its detections, and sends the next.

A request copies its frames and radar points from pinned host buffers to the
device, runs the port's fused pipeline (letterbox, radar projection,
forward, decode, NMS, seg softmax) and reads the detections back; the seg
probabilities stay complete on the device.  The requests cycle a pool of
seeded frame sets.

After the window the reference serves a sample of the requests that the
window completed, drawn from the seed, and the last one: every detection
and each frame's detections are matched one to one with the reference's
greedy NMS; no two of the program's detections of one class may overlap
past the NMS threshold; every detection must lie near one of the
reference's anchors in box (IoU) and in its class's score; the seg
probabilities are compared too.
"""
from __future__ import annotations

import random
import statistics
import time

import torch

from vrbench.common import generator, no_tf32, program_config, seeded_weights
from vrbench.reference import serve as ref_serve
from vrbench.reference.lowp import CONTROL
from vrbench.reference.model import EfficientVRNet, Env

def make_pool(cfg: dict, mix: dict, seed: int, device) -> list[tuple]:
    """`pool` request sets, made on the device and copied to pinned host
    memory: (frames (B,H0,W0,3) uint8 noise, points (B,N,6), valid (B,N)).
    A frame's points land in the letterboxed image's rows of the model
    input; their count is uniform in `valid_points`; range 1-100 m,
    velocity N(0, 3) m/s, elevation N(0, 2) m, power 0-30 dB."""
    g = generator(seed, "serve-pool", device)
    b, n = mix["batch"], mix["radar_points"]
    h0, w0 = mix["frame_hw"]
    h, w = cfg["model"]["input_size"]
    s = min(w / w0, h / h0)
    nh = int(h0 * s)
    dy = (h - nh) // 2
    lo, hi = mix["valid_points"]
    out = []
    for _ in range(mix["pool"]):
        u = lambda *sh: torch.rand(sh, generator=g, device=device)  # noqa: E731
        pts = torch.stack([u(b, n) * w, dy + u(b, n) * nh, 1 + 99 * u(b, n),
                           3 * torch.randn((b, n), generator=g, device=device),
                           2 * torch.randn((b, n), generator=g, device=device),
                           30 * u(b, n)], -1)
        count = torch.randint(lo, hi + 1, (b, 1), generator=g, device=device)
        valid = torch.arange(n, device=device)[None] < count
        frames = torch.randint(0, 256, (b, h0, w0, 3), generator=g, device=device,
                               dtype=torch.uint8)
        pin = device.type == "cuda"
        out.append(tuple(t.cpu().pin_memory() if pin else t.cpu() for t in (frames, pts, valid)))
    return out


def greedy_nms(p: torch.Tensor, num_classes: int, conf: float, thres: float, max_det: int):
    """Greedy class-aware NMS of one frame's decoded predictions (A, 5+C)
    (utils/utils_bbox.py:86-131), in f64 on the host: -> (xyxy boxes,
    scores, classes) of at most `max_det` detections, best first."""
    p = p.detach().to("cpu", torch.float64)
    score, cls = (p[:, 4:5] * p[:, 5:5 + num_classes]).max(-1)
    boxes = torch.cat([p[:, :2] - p[:, 2:4] / 2, p[:, :2] + p[:, 2:4] / 2], -1)
    keep = torch.nonzero(score >= conf)[:, 0]
    order = keep[torch.argsort(score[keep], descending=True, stable=True)]
    b, c = boxes[order], cls[order]
    kill = (box_iou(b, b) > thres) & (c[:, None] == c[None])
    live = torch.ones(len(order), dtype=torch.bool)
    picked = []
    for i in range(len(order)):
        if len(picked) == max_det:
            break
        if live[i]:
            picked.append(i)
            live &= ~kill[i]
    sel = order[picked]
    return boxes[sel], score[sel], cls[sel]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, m) IoU of xyxy boxes."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = lambda t: (t[..., 2:] - t[..., :2]).clamp_min(0).prod(-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter).clamp_min(1e-12)


def matched(boxes_a, cls_a, boxes_b, cls_b, min_iou: float) -> int:
    """Pairs matched one to one between two detection sets: same class and
    IoU >= `min_iou`, the pairs of highest IoU first."""
    if not len(boxes_a) or not len(boxes_b):
        return 0
    iou = box_iou(boxes_a, boxes_b) * (cls_a[:, None] == cls_b[None])
    i, j = torch.nonzero(iou >= min_iou, as_tuple=True)
    used_a, used_b, n = set(), set(), 0
    for k in torch.argsort(iou[i, j], descending=True, stable=True).tolist():
        a, b = int(i[k]), int(j[k])
        if a not in used_a and b not in used_b:
            used_a.add(a)
            used_b.add(b)
            n += 1
    return n


def _cut(scores: torch.Tensor, mix: dict) -> float:
    """The least score a frame's kept detections need: the confidence
    threshold, or the lowest kept score where the frame filled `max_det`."""
    return float(scores.min()) if len(scores) == mix["max_det"] else mix["conf_thres"]


def det_numbers(det: dict, seg: torch.Tensor, ref_pred: torch.Tensor, ref_seg: torch.Tensor,
                mix: dict, input_hw, num_classes: int) -> dict:
    """The numbers of the check for one request.

    Each frame's detections are matched one to one with the reference's
    greedy NMS (same class, IoU at least `match_iou`).  A detection is sure
    where its score clears the frame's cut by `match_margin`: the cut is
    the confidence threshold, or the lowest kept score where a side filled
    `max_det`, the higher of the two sides' (`_cut`).  `det_unmatched`: the share of
    the sure detections, the program's and the reference's over all frames
    together, that find no partner among all of the other side's; a
    detection whose score lies within rounding of a cut may be kept on one
    side and not the other, and is not counted.  `det_unmatched_all`
    (printed): the share of all detections left unmatched.
    `nms_overlap`: the most by which the IoU of two of
    the program's detections of one class in one frame exceeds the NMS
    threshold (0 where none does): NMS's own guarantee.  A detection's gap
    is the least, over the reference's anchors, of max(1 - IoU of the two
    boxes, the gap of the scores of the detection's class): `det_gap` is the
    median detection's, `det_worst` the worst one's.  The seg probabilities'
    absolute gaps: the mean, the median (of a seeded sample of a million)
    and the largest.  `det_per_frame`, `ref_det_per_frame`: the mean counts."""
    dev = ref_pred.device
    size = torch.tensor([input_hw[1], input_hw[0]] * 2, device=dev)
    anchors = torch.cat([ref_pred[..., :2] - ref_pred[..., 2:4] / 2,
                         ref_pred[..., :2] + ref_pred[..., 2:4] / 2], -1) * size
    ref_scores = ref_pred[..., 4:5] * ref_pred[..., 5:5 + num_classes]        # (B, A, C)
    ref_host = ref_pred.cpu()
    gaps, overlap, n_prog, n_ref = [], 0.0, 0, 0
    unmatched, total, unsure, sure = 0, 0, 0, 0
    for f in range(ref_pred.shape[0]):
        ok = det["valid"][f].cpu()
        boxes = det["boxes_xyxy"][f].cpu()[ok].double()
        cls = det["classes"][f].cpu()[ok].long()
        score = det["scores"][f].cpu()[ok].double()
        rboxes, rscore, rcls = greedy_nms(ref_host[f], num_classes, mix["conf_thres"],
                                          mix["nms_thres"], mix["max_det"])
        rcls = rcls.long()
        m = matched(boxes, cls, rboxes, rcls, mix["match_iou"])
        unmatched += len(boxes) + len(rboxes) - 2 * m
        total += len(boxes) + len(rboxes)
        cut = max(_cut(score, mix), _cut(rscore, mix)) + mix["match_margin"]
        ps, rs = score >= cut, rscore >= cut
        unsure += int(ps.sum()) - matched(boxes[ps], cls[ps], rboxes, rcls, mix["match_iou"])
        unsure += int(rs.sum()) - matched(rboxes[rs], rcls[rs], boxes, cls, mix["match_iou"])
        sure += int(ps.sum()) + int(rs.sum())
        n_prog, n_ref = n_prog + len(boxes), n_ref + len(rboxes)
        if len(boxes) > 1:
            iou = box_iou(boxes, boxes) * (cls[:, None] == cls[None])
            iou.fill_diagonal_(0.0)
            overlap = max(overlap, float(iou.max()) - mix["nms_thres"])
        if not len(boxes):
            continue
        a = anchors[f]
        iou = box_iou(boxes.to(dev, torch.float32) * size, a)
        sgap = (det["scores"][f][ok].to(dev)[:, None] - ref_scores[f][:, cls.to(dev)].T).abs()
        gaps.append(torch.maximum(1 - iou, sgap).min(-1).values)
    diff = (seg.to(dev) - ref_seg).abs().flatten()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    sample = diff[torch.randint(0, diff.numel(), (min(diff.numel(), 1 << 20),), generator=g,
                                device=dev)]
    gaps = torch.cat(gaps) if gaps else torch.zeros(1, device=dev)
    frames = ref_pred.shape[0]
    return {"det_unmatched": unsure / max(sure, 1), "det_unmatched_all": unmatched / max(total, 1),
            "nms_overlap": max(overlap, 0.0),
            "det_gap": float(gaps.median()), "det_worst": float(gaps.max()),
            "seg_prob_mean_gap": float(diff.mean()), "seg_prob_median_gap": float(sample.median()),
            "seg_prob_max_gap": float(diff.max()),
            "det_per_frame": n_prog / frames, "ref_det_per_frame": n_ref / frames}


class Driver:
    """One cell's serving traffic on one device."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, fault: str | None = None):
        from asy_vrnet_tpu_torch.infer.pipeline import build_fused_pipeline
        from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model

        self.cfg, self.mix, self.device = cfg, mix, device
        self.batch = mix["batch"]
        self.input_hw = tuple(cfg["model"]["input_size"])
        self.pool = make_pool(cfg, mix, seed, device)
        rows = mix["calibration_rows"]
        frames, pts, valid = (t[:rows].to(device) for t in self.pool[0])
        with no_tf32():
            calib = (ref_serve.letterbox(frames, self.input_hw),
                     ref_serve.rvep(pts, valid, self.input_hw))
        self.weights = seeded_weights(cfg["model"], seed, device, *calib)
        pcfg = program_config(cfg)
        model = create_model(pcfg.model, device)
        model.load_state_dict(self.weights)
        model.eval()
        # the fault "no_suppression": NMS that suppresses nothing (IoU > 1)
        nms = 1.0 if fault == "no_suppression" else mix["nms_thres"]
        pipe = build_fused_pipeline(model, pcfg.model, tuple(mix["frame_hw"]),
                                    mix["conf_thres"], nms, mix["max_det"], radar_minmax=True)
        self.pipe = self._faulty(pipe, fault)
        self.inputs = [torch.empty_like(t, device=device) for t in self.pool[0]]
        # requests whose outputs are kept for the check: drawn from the seed
        # among the first ones every window completes, and the last one
        rng = random.Random(seed)
        self.sampled = set(rng.sample(range(mix["early_requests"]), mix["sampled_requests"]))
        self.kept, self.last = {}, None
        self.issue_s, self.latency_s, self.n = [], [], 0
        for _ in range(mix["warmup_requests"]):
            self._request(0)
        self.latency_s, self.issue_s = [], []

    def _faulty(self, pipe, fault):
        """The pipeline with a planted fault, for the checks of the check."""
        if fault in (None, "no_suppression"):
            return pipe
        if fault == "half_batch":
            def half(image, points, valid):
                k = image.shape[0] // 2
                det, seg = pipe(image[:k], points[:k], valid[:k])
                pad = lambda t: torch.cat([t, torch.zeros_like(t)])  # noqa: E731
                return {n: pad(v) for n, v in det.items()}, pad(seg)
            return half
        if fault == "altered":
            def altered(image, points, valid):
                det, seg = pipe(image, points, valid)
                det = dict(det)
                det["classes"] = (det["classes"] + 1) % self.cfg["model"]["num_classes"]
                return det, seg
            return altered
        raise ValueError(fault)

    def _request(self, j: int):
        t0 = time.perf_counter()
        for dst, src in zip(self.inputs, self.pool[j]):
            dst.copy_(src, non_blocking=True)
        t1 = time.perf_counter()
        det, seg = self.pipe(*self.inputs)
        t2 = time.perf_counter()
        det = {k: v.cpu() for k, v in det.items()}
        self.latency_s.append(time.perf_counter() - t0)
        self.issue_s.append(t2 - t1)
        return det, seg

    def iterate(self) -> None:
        j = self.n % len(self.pool)
        det, seg = self._request(j)
        if self.n in self.sampled:
            self.kept[self.n] = (j, det, seg.clone())
        self.last = (j, det, seg)
        self.n += 1

    def end_to_end(self, window_s: float, iters: int) -> dict:
        lat = self.latency_s
        p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] if len(lat) > 1 else lat[0]
        return {"serve_frames_per_s": (iters * self.batch / window_s, "frames/s"),
                "serve_p95_ms": (p95 * 1e3, "ms")}

    def release(self) -> None:
        self.pipe = None
        self.inputs = None

    def outputs(self) -> list:
        """The kept requests: the sampled ones and the last."""
        return list(self.kept.values()) + ([self.last] if self.last is not None else [])

    def reference(self, j: int, control: bool = False):
        """The reference (with `control`, the control) served on request
        set `j`: (decoded predictions, seg probabilities)."""
        env = Env(**(CONTROL if control else {}))
        model = EfficientVRNet(self.cfg["model"], env).to(self.device)
        model.load_state_dict(self.weights)
        frames, pts, valid = (t.to(self.device) for t in self.pool[j])
        with no_tf32():
            return ref_serve.serve(model, frames, pts, valid, self.input_hw)

    def check(self, control: bool = False) -> dict:
        """Each number's largest over the kept requests; with `control`,
        the control's outputs in the program's place."""
        worst = {}
        for j, det, seg in self.outputs():
            ref_pred, ref_seg = self.reference(j)
            if control:
                det, seg = self.control_outputs(j)
            for k, v in det_numbers(det, seg, ref_pred, ref_seg, self.mix, self.input_hw,
                                    self.cfg["model"]["num_classes"]).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def control_outputs(self, j: int):
        """The control, served through greedy NMS as the pipeline serves:
        (detections dict, seg probabilities)."""
        pred, seg = self.reference(j, control=True)
        mix, k = self.mix, self.mix["max_det"]
        pad = lambda t: torch.cat([t, t.new_zeros((k - len(t),) + t.shape[1:])])  # noqa: E731
        det = {"boxes_xyxy": [], "scores": [], "classes": [], "valid": []}
        for p in pred:
            boxes, score, cls = greedy_nms(p, self.cfg["model"]["num_classes"],
                                           mix["conf_thres"], mix["nms_thres"], k)
            det["boxes_xyxy"].append(pad(boxes))
            det["scores"].append(pad(score))
            det["classes"].append(pad(cls))
            det["valid"].append(pad(torch.ones(len(cls), dtype=torch.bool)))
        return {n: torch.stack(v) for n, v in det.items()}, seg
