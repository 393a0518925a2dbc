"""The reference serving path in plain PyTorch: uint8 camera frames and raw
radar points -> PIL-bicubic letterbox (utils/utils.py:19-32) + ImageNet
normalisation, the radar points' RVEP map (nearest return per pixel) with a
per-frame min-max (yolo.py:134), the forward in eval mode, the decoded
predictions of every anchor (utils/utils_bbox.py:33-84) and the seg
softmax."""
from __future__ import annotations

import numpy as np
import torch

from vrbench.reference.train import IMAGENET_MEAN, IMAGENET_STD, flatten


def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) PIL BICUBIC resampling (a = -0.5, support scaled by
    the downscale factor, rows normalised)."""
    def cubic(t, a=-0.5):
        t = np.abs(t)
        return np.where(t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
                        np.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a, 0.0))

    w = np.zeros((n_out, n_in))
    scale = n_in / n_out
    fs = max(scale, 1.0)
    for i in range(n_out):
        c = (i + 0.5) * scale
        lo, hi = max(int(c - 2 * fs + 0.5), 0), min(int(c + 2 * fs + 0.5), n_in)
        ws = cubic((np.arange(lo, hi) + 0.5 - c) / fs)
        w[i, lo:hi] = ws / ws.sum() if ws.sum() != 0 else ws
    return w.astype(np.float32)


def letterbox(frames_u8: torch.Tensor, out_hw) -> torch.Tensor:
    """(B,H0,W0,3) uint8 -> (B,h,w,3) normalised f32, grey (128) padding."""
    b, h0, w0, _ = frames_u8.shape
    h, w = out_hw
    s = min(w / w0, h / h0)
    nw, nh = int(w0 * s), int(h0 * s)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    dev = frames_u8.device
    mh = torch.as_tensor(_bicubic_matrix(h0, nh), device=dev)
    mw = torch.as_tensor(_bicubic_matrix(w0, nw), device=dev)
    canvas = torch.full((b, h, w, 3), 128.0, device=dev)
    for i in range(b):
        x = frames_u8[i].float().permute(2, 0, 1)                   # (3, H0, W0)
        canvas[i, dy:dy + nh, dx:dx + nw] = (mh @ x @ mw.T).clamp(0, 255).permute(1, 2, 0)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return (canvas / 255.0 - mean) / std


def rvep(points: torch.Tensor, valid: torch.Tensor, out_hw) -> torch.Tensor:
    """(B,N,6) [u, v, range, velocity, elevation, power] points -> (B,h,w,4)
    maps: per pixel the least-range return (ties: the larger value of each
    channel); empty pixels 0; then min-max per frame (+1e-13)."""
    h, w = out_hw
    out = torch.zeros((points.shape[0], h * w, 4), device=points.device)
    for i in range(points.shape[0]):
        p = points[i]
        u, v = torch.round(p[:, 0]).long(), torch.round(p[:, 1]).long()
        ok = valid[i] & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        p, pix = p[ok], (v * w + u)[ok]
        best = torch.full((h * w,), float("inf"), device=p.device)
        best.scatter_reduce_(0, pix, p[:, 2], "amin")
        win = p[:, 2] <= best[pix]
        m = torch.full((h * w, 4), float("-inf"), device=p.device)
        m.scatter_reduce_(0, pix[win, None].expand(-1, 4), p[win, 2:6], "amax")
        out[i] = torch.where(torch.isfinite(m), m, 0.0)
    out = out.view(-1, h, w, 4)
    lo = out.amin(dim=(1, 2, 3), keepdim=True)
    hi = out.amax(dim=(1, 2, 3), keepdim=True)
    return (out - lo) / (hi - lo + 1e-12) + 1e-13


def decode(det, input_hw) -> torch.Tensor:
    """Head maps -> (B, A, 4 + 1 + C): normalised cxcywh, sigmoid obj and
    class scores; a level's stride is input_h / its height."""
    out = flatten(det).float()
    grids, strides = [], []
    for o in det:
        lh, lw = o.shape[1], o.shape[2]
        ys, xs = torch.meshgrid(torch.arange(lh, device=out.device),
                                torch.arange(lw, device=out.device), indexing="ij")
        grids.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float())
        strides.append(torch.full((lh * lw,), input_hw[0] / lh, device=out.device))
    grid, s = torch.cat(grids), torch.cat(strides)[None, :, None]
    xy, wh = (out[..., :2] + grid) * s, torch.exp(out[..., 2:4]) * s
    norm = torch.tensor([input_hw[1], input_hw[0]] * 2, dtype=torch.float32, device=out.device)
    return torch.cat([torch.cat([xy, wh], -1) / norm, torch.sigmoid(out[..., 4:])], -1)


@torch.no_grad()
def serve(model, frames_u8, points, valid, input_hw):
    """-> (decoded predictions (B, A, 5 + C), seg probabilities (B,h,w,S))."""
    model.eval()
    det, seg = model(letterbox(frames_u8, input_hw), rvep(points, valid, input_hw))
    return decode(det, input_hw), torch.softmax(seg, -1)
