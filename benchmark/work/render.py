"""The work of step 6's traced steps, whatever implements it: float32
operations, and bytes of device memory.  Counted from the inputs the
benchmark made (each traced side's keyframe intrinsics and poses, as the
entry's `last` holds them, and the session's depth frames), never from a
counter of the program, so a change of the program's pyramid, budgets or
kernels cannot move it.

The volume's blocks are those the session's frames touch
(reference/integrate.py::touched over every frame), which are the blocks
step 3 allocates.  A block meets a view's frustum unless all eight of its
corners lie outside one of the frustum's six planes (the image's four
edges, z > 0 and z <= 1.5 * depth_max): a conservative test, which may
count a block near a frustum's corner that the frustum misses.

Bytes: each view's map written once (4 bytes a pixel); each block that
meets the frustum of some view of a render call read once per call (tsdf
and weight, 4 bytes each a voxel); each view's K and pose (9 + 16 floats).

Operations per ray that enters the blocks' box (every ray of the room's
views: it is closed, and every ray ends on a surface), the arithmetic of
the plain semantics at the hit, counted by hand: the point o + d * t 6 (an
FMA an axis); the trilinear interpolation 36 (the lattice coordinate 3,
the fraction 3, one minus it 3, the eight corner weights 4 + 8, the eight
products and seven sums 15); the secant 7 (the difference of the values,
the quotient, the clamp 2, the bracket's width, the product and the sum)
= 49.  The march that finds the bracket is left out: how many samples it
takes is the implementation's choice.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.integrate import key_coords, settings, touched
from benchmark.reference.render import batches

OPS_HIT = 6 + 36 + 7
F32 = 4


def session_blocks(session, config) -> torch.Tensor:
    """(B, 3) integer coordinates of the blocks the session's frames touch."""
    s = settings(config)
    dev = session.depth.device
    K = torch.from_numpy(np.asarray(session.K_depth, np.float32)).to(dev)
    T_cw = torch.from_numpy(np.asarray(session.T_cw)).to(dev).float()
    keys = torch.unique(torch.cat([touched(session.depth[f], K[f], T_cw[f], s)
                                   for f in range(len(session.depth))]))
    return key_coords(keys)


def _planes(K: np.ndarray, w: int, h: int, far: float) -> torch.Tensor:
    """(6, 4) half-spaces a.(x, y, z) + b >= 0 of a view's frustum in camera
    coordinates, the image spanning pixels -0.5 to w - 0.5 and h - 0.5."""
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    return torch.tensor([[fx, 0, cx + 0.5, 0], [-fx, 0, w - 0.5 - cx, 0],
                         [0, fy, cy + 0.5, 0], [0, -fy, h - 0.5 - cy, 0],
                         [0, 0, 1, 0], [0, 0, -1, far]], dtype=torch.float64)


def blocks_in_view(corners: torch.Tensor, K, T_cw, w: int, h: int, far: float) -> torch.Tensor:
    """(B,) bool: the blocks with world corners `corners` (B, 8, 3) float64
    that meet the frustum of the view K, T_cw (camera-to-world)."""
    T = torch.as_tensor(np.asarray(T_cw, np.float64), device=corners.device)
    cam = (corners - T[:3, 3]) @ T[:3, :3]  # R^T (p - t)
    pl = _planes(K, w, h, far).to(corners.device)
    side = cam @ pl[:, :3].T + pl[:, 3]  # (B, 8, 6)
    return ~(side < 0).all(1).any(-1)


def count(session, config, traced) -> tuple:
    """(ops, bytes) of the traced steps, each as the entry's `last` ("K"
    (V, 3, 3) with cx flipped, "T_cw" (V, 4, 4), "width", "height",
    "batch")."""
    return work(session_blocks(session, config), config, traced)


def work(coords: torch.Tensor, config, traced) -> tuple:
    """(ops, bytes) of the traced steps over a volume of the blocks at
    integer coordinates `coords` (B, 3)."""
    s = settings(config)
    R, vs = s["R"], s["voxel_size"]
    coords = coords.double()
    dev = coords.device
    c = torch.tensor([[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)],
                     dtype=torch.float64, device=dev)
    corners = (coords[:, None, :] + c[None]) * (R * vs)  # (B, 8, 3)
    lo, hi = corners.amin((0, 1)), corners.amax((0, 1))
    far = 1.5 * s["depth_max"]
    ops = nbytes = 0.0
    for step in traced:
        w, h, K, T = step["width"], step["height"], step["K"], step["T_cw"]
        for i, j in batches(len(K), step["batch"]):
            meet = torch.zeros(len(coords), dtype=torch.bool, device=dev)
            for v in range(i, j):
                meet |= blocks_in_view(corners, K[v], T[v], w, h, far)
            nbytes += int(meet.sum()) * R ** 3 * 2 * F32
        for v in range(len(K)):
            ops += rays_into_box(K[v], T[v], w, h, lo, hi) * OPS_HIT
        nbytes += len(K) * (w * h + 9 + 16) * F32
    return ops, nbytes


def rays_into_box(K, T_cw, w: int, h: int, lo: torch.Tensor, hi: torch.Tensor) -> int:
    """How many of a view's pixel rays meet the box [lo, hi] ahead of the
    camera."""
    dev = lo.device
    K = np.asarray(K, np.float64)
    T = torch.as_tensor(np.asarray(T_cw, np.float64), device=dev)
    u = torch.arange(w, dtype=torch.float64, device=dev)
    v = torch.arange(h, dtype=torch.float64, device=dev)
    cam = torch.stack([((u[None, :] - K[0, 2]) / K[0, 0]).expand(h, w),
                       ((v[:, None] - K[1, 2]) / K[1, 1]).expand(h, w),
                       torch.ones((h, w), dtype=torch.float64, device=dev)], -1)
    d = cam @ T[:3, :3].T
    d = torch.where(d == 0, torch.full_like(d, 1e-300), d)
    t1, t2 = (lo - T[:3, 3]) / d, (hi - T[:3, 3]) / d
    t_in = torch.minimum(t1, t2).amax(-1)
    t_out = torch.maximum(t1, t2).amin(-1)
    return int(((t_out >= t_in) & (t_out > 0)).sum())
