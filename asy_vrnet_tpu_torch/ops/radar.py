"""Radar point cloud -> RVEP map projection on the device (counterpart of
`asy_vrnet_tpu/ops/radar.py`).

The reference reads range/velocity/elevation/power maps projected offline
(.npz, utils/dataloader.py:111-112); the fused pipeline projects raw points
itself:

  points: (N, 6) float32 = [u, v, range, velocity, elevation, power], (u, v)
          in camera pixels; padding rows carry u = v = -1.
  output: (H, W, 4) RVEP map; where several points land in one pixel the
          nearest (least range) return wins.

A scatter-min of the ranges, then a scatter-max of the winners' RVEP
vectors, both over a fixed-size point buffer with a sink slot for dropped
points: no host round trip.
"""
from __future__ import annotations

import torch


def project_points_to_rvep(points: torch.Tensor, valid: torch.Tensor,
                           out_hw: tuple[int, int]) -> torch.Tensor:
    """points (..., N, 6) f32, valid (..., N) bool -> (..., H, W, 4) f32 RVEP
    maps, one per leading index (the JAX version takes one cloud and is
    vmapped)."""
    h, w = out_hw
    n = h * w
    lead = points.shape[:-2]
    points = points.reshape(-1, points.shape[-2], 6)
    valid = valid.reshape(-1, valid.shape[-1])
    b, dev = points.shape[0], points.device
    u = torch.round(points[..., 0]).to(torch.int64)     # half to even, as jnp.round
    v = torch.round(points[..., 1]).to(torch.int64)
    ok = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat = torch.where(ok, v * w + u, torch.full_like(u, n))   # dropped -> sink slot n
    base = torch.arange(b, device=dev)[:, None] * (n + 1)      # each cloud's own slots
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)

    rng = torch.full((b * (n + 1),), float("inf"), dtype=torch.float32, device=dev)
    rng = rng.scatter_reduce(0, (flat + base).reshape(-1),
                             torch.where(ok, points[..., 2], inf).reshape(-1), "amin",
                             include_self=True).view(b, n + 1)
    # winners: every point whose range equals its pixel's least range (equal
    # ranges all win; each channel then takes the larger value)
    win = ok & (points[..., 2] <= rng.gather(1, flat.clamp_max(n - 1)))
    rvep = torch.where(win[..., None], points[..., 2:6], -inf)
    out = torch.full((b * (n + 1), 4), float("-inf"), dtype=torch.float32, device=dev)
    out = out.scatter_reduce(0, (flat + base).reshape(-1, 1).expand(-1, 4),
                             rvep.reshape(-1, 4), "amax", include_self=True)
    out = out.view(b, n + 1, 4)[:, :n]
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out.reshape(*lead, h, w, 4)


def rvep_from_npz_layout(radar_chw: torch.Tensor) -> torch.Tensor:
    """(4, H, W) on-disk layout -> (H, W, 4)."""
    return radar_chw.permute(1, 2, 0)
