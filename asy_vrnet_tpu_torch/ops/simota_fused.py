"""Batched SimOTA assignment (counterpart of
`asy_vrnet_tpu/ops/simota_pallas.py`): the hand-written CUDA kernel
(`csrc/simota_assign.cu`) on CUDA tensors, the plain twin
(`ops/simota.py::simota_assign`, one image at a time) on CPU tensors.

On a CUDA tensor the wrapper launches the kernel or raises; nothing falls
back.  LAUNCHES counts wrapper calls that launched the kernel (one call runs
its three stages: prep, rows, resolve).
"""
from __future__ import annotations

import torch

from asy_vrnet_tpu_torch.ops.simota import SimOTAResult, simota_assign

# kernel launches per wrapper; plain-version calls are not counted
LAUNCHES = {"simota_assign": 0}


def _plain_batched(pred_boxes, cls_logits, obj_logits, gt_boxes, gt_classes, gt_valid,
                   grids, strides, center_radius, candidate_k):
    """The plain twin over a batch -> (SimOTAResult with a leading batch
    dimension, dynamic_ks (B,G))."""
    per_image = [simota_assign(pred_boxes[i], cls_logits[i], obj_logits[i], gt_boxes[i],
                               gt_classes[i], gt_valid[i], grids, strides,
                               center_radius=center_radius, candidate_k=candidate_k,
                               return_dynamic_ks=True)
                 for i in range(pred_boxes.shape[0])]
    result = SimOTAResult(*(torch.stack(f) for f in zip(*(r for r, _ in per_image))))
    return result, torch.stack([d for _, d in per_image])


def _kernel_batched(pred_boxes, cls_logits, obj_logits, gt_boxes, gt_classes, gt_valid,
                    grids, strides, center_radius, candidate_k):
    from asy_vrnet_tpu_torch.ops import kernels

    dev = pred_boxes.device
    b, a, c = cls_logits.shape
    g = gt_boxes.shape[1]
    want = (("pred_boxes", pred_boxes, (b, a, 4)), ("obj_logits", obj_logits, (b, a)),
            ("gt_boxes", gt_boxes, (b, g, 4)), ("gt_classes", gt_classes, (b, g)),
            ("gt_valid", gt_valid, (b, g)), ("grids", grids, (a, 2)),
            ("strides", strides, (a,)))
    for name, t, shape in want:
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"simota_assign: {name} must have shape {shape} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    f32, i32 = torch.float32, torch.int32
    pb, cl, ob, gb, gr, sv = (t.detach().to(f32).contiguous() for t in
                              (pred_boxes, cls_logits, obj_logits, gt_boxes, grids, strides))
    gc = gt_classes.to(i32).contiguous()
    gv = gt_valid.to(torch.uint8).contiguous()
    fg_pre = torch.empty((b, a), dtype=torch.uint8, device=dev)
    logs = torch.empty((b, 2 * c, a), dtype=f32, device=dev)
    picks = torch.empty((b, a, 2), dtype=i32, device=dev)
    dynamic_ks = torch.empty((b, g), dtype=i32, device=dev)
    fg = torch.empty((b, a), dtype=torch.uint8, device=dev)
    matched = torch.empty((b, a), dtype=i32, device=dev)
    pred_iou = torch.empty((b, a), dtype=f32, device=dev)
    kernels.simota_assign(pb, cl, ob, gb, gc, gv, gr, sv, fg_pre, logs, picks, dynamic_ks,
                          fg, matched, pred_iou, center_radius=float(center_radius),
                          candidate_k=int(candidate_k))
    LAUNCHES["simota_assign"] += 1
    fg = fg.bool()
    return SimOTAResult(fg, matched.long(), pred_iou, fg.to(f32).sum(dim=1)), dynamic_ks


@torch.no_grad()
def simota_assign_batched(
    pred_boxes,     # (B, A, 4) cxcywh absolute
    cls_logits,     # (B, A, C)
    obj_logits,     # (B, A)
    gt_boxes,       # (B, G, 4)
    gt_classes,     # (B, G) int
    gt_valid,       # (B, G) bool
    grids,          # (A, 2)
    strides,        # (A,)
    center_radius: float = 2.5,
    candidate_k: int = 10,
    use_kernel: bool | None = None,
    return_dynamic_ks: bool = False,
):
    """Batched SimOTA -> SimOTAResult with (B, A) fields and num_fg (B,)
    [, dynamic_ks (B,G) int32].  `use_kernel=None` takes the kernel iff the
    tensors lie on a CUDA device (and then launches it or raises); False runs
    the plain twin image by image on whatever device holds the tensors; True
    on a CPU tensor raises, since a CUDA kernel cannot run there."""
    on_cuda = pred_boxes.device.type == "cuda"
    if use_kernel is None:
        use_kernel = on_cuda
    if use_kernel and not on_cuda:
        raise ValueError("simota_assign_batched: use_kernel=True needs CUDA tensors, "
                         f"got {pred_boxes.device}")
    run = _kernel_batched if use_kernel else _plain_batched
    result, dynamic_ks = run(pred_boxes, cls_logits, obj_logits, gt_boxes, gt_classes,
                             gt_valid, grids, strides, center_radius, candidate_k)
    return (result, dynamic_ks) if return_dynamic_ks else result
