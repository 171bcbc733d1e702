"""Geometry comparison metrics: chamfer, Hausdorff, F-score, volume IoU.

Counterpart of mq3d_tpu/eval/metrics.py, a re-design of the reference's
ground-truth comparison suite (reference:
analysis/computation/compare_mesh_to_ground_truth.py:139-343): the same
metric definitions, with nearest-neighbor distances computed as tiled
brute force, |s|^2 + |t|^2 - 2 s.t, on `device` instead of KD-trees.

The distances equal the JAX build's bit for bit on every device: XLA's CPU
code forms the squared norms and the 3-term dot product as fused
multiply-add chains, fma(z, z', fma(y, y', x x')), and then
(|s|^2 + |t|^2) - 2 s.t; here each fused multiply-add is ops/fma.py's
correctly rounded `fma` and the square root is taken in float64, so no
TF32 matmul setting of the caller and no contraction choice of a compiler
touches the result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.ops.fma import fma


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis (size 3) as XLA's CPU code contracts it:
    fma(a2, b2, fma(a1, b1, a0 * b0)), broadcasting a against b."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def nearest_distances(src: np.ndarray, tgt: np.ndarray, tile: Optional[int] = None,
                      target_tile: Optional[int] = None, device="cuda") -> np.ndarray:
    """Exact nearest-neighbor distances src -> tgt (brute force, float32).

    Sources go in tiles of `tile` points, targets in tiles of `target_tile`
    with a running minimum, so memory stays at one tile x target_tile
    block whatever the sizes (the JAX build holds a tile x all-targets
    block and pads its last source tile with 1e9; here the last tile is
    just shorter, which changes no other row).  The default block is
    4096 x 4096 on the card (fewer, larger launches) and 256 x 1024 on the
    CPU, where `fma`'s float64 temporaries then stay in cache (about 5x
    faster there than 4096 x 4096); the result does not depend on it."""
    src = np.asarray(src, np.float32)
    tgt = np.asarray(tgt, np.float32)
    if len(src) == 0 or len(tgt) == 0:
        return np.full(len(src), np.inf, np.float32)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    tile = tile or (4096 if on_card else 256)
    target_tile = target_tile or (4096 if on_card else 1024)
    s_all = torch.from_numpy(src).to(dev)
    t_all = torch.from_numpy(tgt).to(dev)
    t2_all = _dot3(t_all, t_all)
    out = torch.empty(len(src), dtype=torch.float32, device=dev)
    for s in range(0, len(src), tile):
        chunk = s_all[s:s + tile]
        s2 = _dot3(chunk, chunk)[:, None]
        best = None
        for t in range(0, len(tgt), target_tile):
            tt = t_all[t:t + target_tile]
            d2 = (s2 + t2_all[None, t:t + target_tile]).sub_(
                _dot3(chunk[:, None, :], tt[None, :, :]), alpha=2.0).amin(dim=1)
            best = d2 if best is None else torch.minimum(best, d2)
        out[s:s + tile] = best.clamp_min_(0.0).double().sqrt_().float()
    return out.cpu().numpy()


@dataclass
class GeometryComparison:
    chamfer: float
    hausdorff: float
    mean_to_gt: float
    mean_from_gt: float
    precision: float
    recall: float
    fscore: float
    threshold: float


def compare_point_clouds(
    pred: np.ndarray,
    gt: np.ndarray,
    fscore_threshold: Optional[float] = None,
    device="cuda",
) -> GeometryComparison:
    """Chamfer / Hausdorff / F-score@tau between two point sets.

    tau defaults to 1% of the GT bounding-box diagonal (reference
    compare_mesh_to_ground_truth.py:232 default)."""
    if fscore_threshold is None:
        diag = float(np.linalg.norm(gt.max(0) - gt.min(0)))
        fscore_threshold = 0.01 * diag

    d_pg = nearest_distances(pred, gt, device=device)
    d_gp = nearest_distances(gt, pred, device=device)

    mean_to_gt = float(d_pg.mean())
    mean_from_gt = float(d_gp.mean())
    chamfer = mean_to_gt + mean_from_gt
    hausdorff = float(max(d_pg.max(), d_gp.max()))
    precision = float((d_pg <= fscore_threshold).mean())
    recall = float((d_gp <= fscore_threshold).mean())
    fscore = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0
        else 0.0
    )
    return GeometryComparison(
        chamfer=chamfer,
        hausdorff=hausdorff,
        mean_to_gt=mean_to_gt,
        mean_from_gt=mean_from_gt,
        precision=precision,
        recall=recall,
        fscore=fscore,
        threshold=fscore_threshold,
    )


def voxel_iou(pred: np.ndarray, gt: np.ndarray, voxel_size: float) -> float:
    """Occupied-voxel IoU between two point sets (reference :280-342)."""
    def occ(points):
        keys = np.floor(points / voxel_size).astype(np.int64)
        return set(map(tuple, keys))

    a = occ(pred)
    b = occ(gt)
    if not a and not b:
        return 1.0
    return len(a & b) / max(len(a | b), 1)


def mesh_surface_area(vertices: np.ndarray, triangles: np.ndarray) -> float:
    p0 = vertices[triangles[:, 0]]
    p1 = vertices[triangles[:, 1]]
    p2 = vertices[triangles[:, 2]]
    return float(0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1).sum())


def count_boundary_edges(triangles: np.ndarray) -> int:
    """Edges referenced by exactly one triangle (hole boundary length)."""
    edges = np.concatenate(
        [triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]]
    )
    edges = np.sort(edges, axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return int((counts == 1).sum())


def count_holes(vertices: np.ndarray, triangles: np.ndarray,
                min_hole_size_ratio: float = 0.01) -> int:
    """Significant boundary loops (holes): connected components of the
    boundary-edge graph whose perimeter exceeds min_hole_size_ratio of the
    bbox diagonal (reference compare_mesh_to_ground_truth.py:364-494,
    re-designed as sparse connected components instead of loop walking)."""
    if len(triangles) == 0:
        return 0
    nv = len(vertices)
    edges = np.concatenate(
        [triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    keys = edges[:, 0].astype(np.int64) * nv + edges[:, 1]
    uniq, counts = np.unique(keys, return_counts=True)
    b = uniq[counts == 1]
    if len(b) == 0:
        return 0
    u = (b // nv).astype(np.int64)
    v = (b % nv).astype(np.int64)

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    # Restrict the graph to boundary vertices only.
    bverts, inv = np.unique(np.concatenate([u, v]), return_inverse=True)
    iu, iv = inv[:len(u)], inv[len(u):]
    adj = coo_matrix((np.ones(len(u), np.int8), (iu, iv)),
                     shape=(len(bverts), len(bverts)))
    n_comp, labels = connected_components(adj, directed=False)

    lengths = np.linalg.norm(vertices[u] - vertices[v], axis=-1)
    perimeters = np.zeros(n_comp)
    np.add.at(perimeters, labels[iu], lengths)

    diag = float(np.linalg.norm(vertices.max(0) - vertices.min(0)))
    return int((perimeters >= diag * min_hole_size_ratio).sum())


def normalize_scale(points: np.ndarray,
                    reference_points: np.ndarray) -> tuple:
    """Scale points (around their bbox center) so the bbox diagonal
    matches the reference's (reference :626-671).
    Returns (scaled points, scale factor)."""
    extent = points.max(0) - points.min(0)
    current = float(np.linalg.norm(extent))
    target = float(np.linalg.norm(
        reference_points.max(0) - reference_points.min(0)))
    if current == 0:
        return points, 1.0
    factor = target / current
    center = (points.max(0) + points.min(0)) / 2
    return (points - center) * factor + center, factor
