"""Depth-odometry information matrices (counterpart of
mq3d_tpu/ops/odometry.py).

Open3D's compute_odometry_information_matrix (reference make_fragments.py:
142-150, 228-232): given two depth maps and a source-to-target pose, count
the reprojection correspondences within dist_threshold and sum the 6x6
Gauss-Newton information G^T G over the corresponding target points q,
with G = [skew(q)^T | I] in (rx, ry, rz, tx, ty, tz) order.

The sum has a closed form, [[|q|^2 I - q q^T, skew(s)], [skew(s)^T, n I]]
with s = sum q, so only n, sum q and sum q q^T are reduced (in float64),
and no (H, W, 3, 6) Jacobian is formed; the JAX package forms it and
bounds its memory with lax.map over 8 edges.  The correspondence test
follows XLA's CPU arithmetic (`ops.tsdf._apply_pose`), so the counts and
the loop gate equal the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from mq3d_tpu_torch.ops.tsdf import _apply_pose, _norm3, _to_i32

# Edges per pass of odometry_information_matrix_batch: bounds its
# (edges, H, W, 3) intermediates to a few hundred MB at 320x288.
EDGES_PER_PASS = 32


def _unproject(depth, K):
    """(..., H, W) depth and (..., 3, 3) intrinsics -> (..., H, W, 3)."""
    h, w = depth.shape[-2:]
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    return torch.stack([x, y, depth], dim=-1)


def _information_stats(source_depth, target_depth, K, source_to_target,
                       dist_threshold: float, depth_max: float):
    """Masked correspondence sums of E pairs: source_depth, target_depth
    (E, H, W), K (3, 3), source_to_target (E, 4, 4) float32.  Returns
    (n (E,) int64, sum q (E, 3) float64, sum q q^T (E, 3, 3) float64)."""
    h, w = source_depth.shape[-2:]
    src_ok = (source_depth > 0) & (source_depth <= depth_max)
    p_t = _apply_pose(_unproject(source_depth, K), source_to_target[:, None, None])

    z = p_t[..., 2]
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    u = K[0, 0] * p_t[..., 0] / z_safe + K[0, 2]
    v = K[1, 1] * p_t[..., 1] / z_safe + K[1, 2]
    ui = _to_i32(torch.floor(u + 0.5))
    vi = _to_i32(torch.floor(v + 0.5))
    in_img = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (z > 0)

    idx = (vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)).long()
    d_t = torch.gather(target_depth.reshape(-1, h * w), 1, idx.reshape(-1, h * w)).reshape(idx.shape)
    tgt_ok = (d_t > 0) & (d_t <= depth_max)

    q = torch.stack([(ui.float() - K[0, 2]) * d_t / K[0, 0],
                     (vi.float() - K[1, 2]) * d_t / K[1, 1], d_t], dim=-1)
    dist = _norm3(p_t - q)
    corr = src_ok & in_img & tgt_ok & (dist < dist_threshold)

    qd = torch.where(corr[..., None], q, torch.zeros((), device=q.device)).double().flatten(1, 2)
    return corr.flatten(1).sum(1), qd.sum(1), qd.transpose(1, 2) @ qd


def _assemble(n: int, s: np.ndarray, S: np.ndarray) -> np.ndarray:
    """sum G^T G from n, s = sum q and S = sum q q^T."""
    skew_s = np.array([[0.0, -s[2], s[1]], [s[2], 0.0, -s[0]], [-s[1], s[0], 0.0]])
    info = np.zeros((6, 6))
    info[:3, :3] = np.trace(S) * np.eye(3) - S
    info[:3, 3:] = skew_s
    info[3:, :3] = skew_s.T
    info[3:, 3:] = float(n) * np.eye(3)
    return info


def odometry_information_matrix(source_depth, target_depth, intrinsic, source_to_target,
                                dist_threshold: float, depth_max: float):
    """One pair: source_depth, target_depth (H, W) float32 tensors,
    intrinsic (3, 3), source_to_target (4, 4), on one device.  Returns
    (info (6, 6) float64 numpy, n_corr int), the Open3D op's outputs."""
    infos, n = odometry_information_matrix_batch(
        torch.stack([source_depth, target_depth]), intrinsic,
        np.asarray([[0, 1]]), source_to_target[None], dist_threshold, depth_max)
    return infos[0], int(n[0])


def odometry_information_matrix_batch(depth_stack, intrinsic, pairs, source_to_target,
                                      dist_threshold: float, depth_max: float):
    """All of a fragment's odometry and loop edges: depth_stack (N, H, W)
    float32, intrinsic (3, 3) float32 and source_to_target (E, 4, 4)
    float32 tensors on one device, pairs (E, 2) (source, target) indices.
    Passes of EDGES_PER_PASS edges.  Returns (info (E, 6, 6) float64,
    n_corr (E,) int64) as numpy arrays."""
    K = intrinsic.float()
    T = source_to_target.float()
    pairs = torch.as_tensor(np.asarray(pairs, np.int64), device=depth_stack.device)
    if len(pairs) == 0:
        return np.zeros((0, 6, 6)), np.zeros(0, np.int64)
    ns, ss, Ss = [], [], []
    for e0 in range(0, len(pairs), EDGES_PER_PASS):
        p = pairs[e0:e0 + EDGES_PER_PASS]
        n, s, S = _information_stats(depth_stack[p[:, 0]], depth_stack[p[:, 1]], K,
                                     T[e0:e0 + EDGES_PER_PASS], dist_threshold, depth_max)
        ns.append(n)
        ss.append(s)
        Ss.append(S)
    n = torch.cat(ns).cpu().numpy()
    s = torch.cat(ss).cpu().numpy()
    S = torch.cat(Ss).cpu().numpy()
    infos = np.stack([_assemble(int(n[e]), s[e], S[e]) for e in range(len(n))])
    return infos, n
