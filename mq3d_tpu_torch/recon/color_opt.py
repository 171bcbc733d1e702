"""Color-map optimization: photometric camera refinement + color baking.

Counterpart of mq3d_tpu/recon/color_opt.py (the reference's
o3d.pipelines.color_map.run_rigid_optimizer, optimize_color_pose.py:11-100):
keyframe color images (every `interval`-th frame, both sides) are
registered against the TSDF mesh by alternating (a) per-vertex target
intensities C(v), the mean of the sampled image intensities over visible
frames, and (b) per-frame rigid Gauss-Newton steps minimizing
sum_v (C(v) - I_f(pi(T_f v)))^2, the rigid variant of Zhou & Koltun 2014.
Visibility comes from the TSDF-raycast depth in each color view.  Finally,
vertex colors bake as the mean of the sampled RGB over visible frames.

Vertex-level work (projection, bilinear sampling, the normal equations) runs
on the volume's device as plain PyTorch with a leading frame dimension, in
chunks of up to `_FRAMES_PER_LAUNCH` frames of one resolution; H and b
accumulate in float64, as the JAX build's preferred_element_type=float64
does.  The 6x6 solves and pose updates run on the host in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from mq3d_tpu_torch.config.configs import ColorOptimizationConfig
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.dataio.ply import TriangleMesh
from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.geometry import se3
from mq3d_tpu_torch.models.datasets import CameraDataset
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem, Transforms
from mq3d_tpu_torch.ops.mesh_filter import filter_mesh_components
from mq3d_tpu_torch.ops.raycast import raycast_depth
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.utils.log import substep

VIS_DEPTH_THRESHOLD = 0.03  # meters; visibility depth-consistency margin
_FRAMES_PER_LAUNCH = 32  # frames per batched call (the JAX build's default)


def _sample_bilinear(img, u, v):
    """Bilinear sample of (F, H, W) or (F, H, W, C) images at float coords
    u, v (F, N).  Returns (value (F, N[, C]), in_bounds (F, N))."""
    F, h, w = img.shape[:3]
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    inb = (u0 >= 0) & (u0 + 1 < w) & (v0 >= 0) & (v0 + 1 < h)
    u0c = torch.clamp(u0, 0, w - 2)
    v0c = torch.clamp(v0, 0, h - 2)
    fu = u - u0c
    fv = v - v0c
    flat = img.reshape(F, h * w, *img.shape[3:])
    base = v0c * w + u0c

    def at(off):
        idx = base + off
        if img.ndim == 4:
            idx = idx[..., None].expand(-1, -1, img.shape[3])
        return torch.gather(flat, 1, idx)

    if img.ndim == 4:
        fu, fv = fu[..., None], fv[..., None]
    val = (at(0) * (1 - fu) * (1 - fv) + at(1) * fu * (1 - fv)
           + at(w) * (1 - fu) * fv + at(w + 1) * fu * fv)
    return val, inb


def _project(verts, K, T_wc):
    """verts (N, 3), K (F, 3, 3), T_wc (F, 4, 4) -> u, v, z (F, N) and
    camera points p (F, N, 3)."""
    R = T_wc[:, None, :3, :3]
    p = torch.stack([R[..., i, 0] * verts[:, 0] + R[..., i, 1] * verts[:, 1]
                     + R[..., i, 2] * verts[:, 2] + T_wc[:, None, i, 3]
                     for i in range(3)], dim=-1)
    z = p[..., 2]
    zs = torch.where(z > 1e-6, z, torch.ones((), dtype=z.dtype, device=z.device))
    u = K[:, None, 0, 0] * p[..., 0] / zs + K[:, None, 0, 2]
    v = K[:, None, 1, 1] * p[..., 1] / zs + K[:, None, 1, 2]
    return u, v, z, p


def _visibility(verts, K, T_wc, render_depth):
    """(F, N) visibility of the vertices against (F, H, W) rendered depth."""
    u, v, z, _ = _project(verts, K, T_wc)
    d, inb = _sample_bilinear(render_depth, u, v)
    ok = inb & (z > 1e-6) & torch.isfinite(d)
    return ok & ((d - z).abs() < VIS_DEPTH_THRESHOLD)


def _sample_intensity(verts, K, T_wc, gray, visible):
    u, v, z, _ = _project(verts, K, T_wc)
    val, inb = _sample_bilinear(gray, u, v)
    ok = visible & inb & (z > 1e-6)
    return torch.where(ok, val, torch.zeros((), dtype=val.dtype, device=val.device)), ok


def _gn_terms(verts, K, T_wc, gray, gx, gy, target_c, visible):
    """Per-frame Gauss-Newton normal equations for the photometric
    residual: H (F, 6, 6) and b (F, 6) in float64, residual (F,) and
    valid-vertex count (F,)."""
    u, v, z, p = _project(verts, K, T_wc)
    val, inb = _sample_bilinear(gray, u, v)
    dIdu, _ = _sample_bilinear(gx, u, v)
    dIdv, _ = _sample_bilinear(gy, u, v)
    ok = visible & inb & (z > 1e-6)
    r = val - target_c[None]  # residual of I(pi(Tv)) - C(v)

    zs = torch.where(z > 1e-6, z, torch.ones((), dtype=z.dtype, device=z.device))
    fx, fy = K[:, None, 0, 0], K[:, None, 1, 1]
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    # dI/dp = dI/du du/dp + dI/dv dv/dp.
    g0 = dIdu * (fx / zs)
    g1 = dIdv * (fy / zs)
    g2 = dIdu * (-fx * px / zs ** 2) + dIdv * (-fy * py / zs ** 2)
    # Left perturbation on T_wc: dp/d(omega, upsilon) = [-[p]x | I].
    J = torch.stack([py * g2 - pz * g1, pz * g0 - px * g2, px * g1 - py * g0,
                     g0, g1, g2], dim=-1)  # (F, N, 6)
    zero = torch.zeros((), dtype=J.dtype, device=J.device)
    J = torch.where(ok[..., None], J, zero)
    rm = torch.where(ok, r, zero)
    Jd = J.double()
    H = Jd.transpose(1, 2) @ Jd
    b = (Jd * rm.double()[..., None]).sum(dim=1)
    return H, b, (rm * rm).sum(dim=1), ok.sum(dim=1)


def _sample_rgb(verts, K, T_wc, rgb, visible):
    u, v, z, _ = _project(verts, K, T_wc)
    val, inb = _sample_bilinear(rgb, u, v)
    ok = visible & inb & (z > 1e-6)
    return torch.where(ok[..., None], val, torch.zeros((), dtype=val.dtype,
                                                       device=val.device)), ok


def _load_keyframes(vbg: TSDFVolume, data_io: DataIO, config: ColorOptimizationConfig):
    """Every `interval`-th colour frame of both sides, in the OPEN3D camera
    frame: ({side: keyframe dataset}, [per-frame dict of K, pose T_wc
    (float64, host), gray, its gradients, RGB and the raycast depth])."""
    dev = vbg.device

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    color_dataset_map: Dict[Side, CameraDataset] = {}
    frames = []
    for side in Side:
        ds = data_io.color.load_color_dataset(side=side, use_cache=config.use_dataset_cache)
        ds = ds[:: max(config.interval, 1)]
        ds.transforms = ds.transforms.convert_coordinate_system(
            CoordinateSystem.OPEN3D, is_camera=True)
        color_dataset_map[side] = ds

        K_all = ds.get_render_intrinsic_matrices().astype(np.float32)
        T_all = ds.transforms.extrinsics_wc.astype(np.float64)
        print(f"[{side.name}] Preparing {len(ds)} keyframes")
        for i in range(len(ds)):
            rgb = data_io.color.load_rgb(side, int(ds.timestamps[i])).astype(np.float32) / 255.0
            gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
            gy_, gx_ = np.gradient(gray)
            depth = raycast_depth(vbg, K_all[i], T_all[i], int(ds.widths[i]),
                                  int(ds.heights[i]))
            frames.append({
                "side": side, "idx": i, "K": on_dev(K_all[i]), "T": T_all[i],
                "gray": on_dev(gray), "gx": on_dev(gx_), "gy": on_dev(gy_),
                "rgb": on_dev(rgb), "depth": on_dev(depth),
            })
    return color_dataset_map, frames


def optimize_color_pose(vbg: TSDFVolume, data_io: DataIO, config: ColorOptimizationConfig,
                        mesh: TriangleMesh) -> Tuple[TriangleMesh, Dict[Side, CameraDataset]]:
    """The reference's optimize_color_pose on `mesh`, the volume's mesh as
    step 4 extracts and filters it (config.weight_threshold and
    config.min_triangle_count; the JAX build extracts and filters it again
    here, with the same result).  Returns the colored, component-filtered
    mesh and the pose-refined keyframe color datasets per side.  Runs on
    the volume's device; `mesh` is not modified."""
    dev = vbg.device
    verts = torch.from_numpy(np.asarray(mesh.vertices, np.float32)).to(dev)
    with substep("color_opt.keyframes"):
        color_dataset_map, frames = _load_keyframes(vbg, data_io, config)
    if len(frames) == 0 or len(mesh.vertices) == 0:
        return mesh, color_dataset_map

    # Chunks of frames of one resolution, so the stacked images stay
    # rectangular.
    by_shape: Dict[tuple, list] = {}
    for fi, f in enumerate(frames):
        by_shape.setdefault(tuple(f["gray"].shape), []).append(fi)
    chunks = [ids[s0:s0 + _FRAMES_PER_LAUNCH] for ids in by_shape.values()
              for s0 in range(0, len(ids), _FRAMES_PER_LAUNCH)]

    def stack(ids, key):
        return torch.stack([frames[i][key] for i in ids])

    def poses(ids):
        T = np.stack([frames[i]["T"] for i in ids]).astype(np.float32)
        return torch.from_numpy(T).to(dev)

    # Visibility from the initial geometry, held fixed (as in the
    # reference's rigid optimizer).
    static = []
    for ids in chunks:
        st = {k: stack(ids, k) for k in ("K", "gray", "gx", "gy")}
        st["vis"] = _visibility(verts, st["K"], poses(ids), stack(ids, "depth"))
        static.append(st)

    def vertex_targets():
        acc = torch.zeros(verts.shape[0], dtype=torch.float32, device=dev)
        cnt = torch.zeros(verts.shape[0], dtype=torch.float32, device=dev)
        for ids, st in zip(chunks, static):
            val, ok = _sample_intensity(verts, st["K"], poses(ids), st["gray"], st["vis"])
            acc = acc + val.sum(0)
            cnt = cnt + ok.sum(0).float()
        return acc / torch.clamp(cnt, min=1.0)

    # --- alternating optimization --------------------------------------------
    residuals = []
    with substep("color_opt.gauss_newton"):
        prev_res = np.inf
        for it in range(max(config.max_iteration, 1)):
            target_c = vertex_targets()
            total_res = 0.0
            for ids, st in zip(chunks, static):
                Hs, bs, ress, n_oks = (x.cpu().numpy() for x in _gn_terms(
                    verts, st["K"], poses(ids), st["gray"], st["gx"], st["gy"], target_c,
                    st["vis"]))
                for j, fi in enumerate(ids):
                    H, b = Hs[j], bs[j]
                    if int(n_oks[j]) < 100:
                        continue
                    try:
                        dx = np.linalg.solve(
                            H + 1e-6 * np.eye(6) * max(np.trace(H) / 6, 1e-12), -b)
                    except np.linalg.LinAlgError:
                        continue
                    frames[fi]["T"] = np.asarray(se3.se3_exp(dx)) @ frames[fi]["T"]
                    total_res += float(ress[j])
            residuals.append(total_res)
            if it % 10 == 0:
                print(f"[ColorOpt] iter {it}: residual {total_res:.4f}")
            if it >= 10 and abs(prev_res - total_res) < 1e-4 * max(total_res, 1e-12):
                print(f"[ColorOpt] converged at iter {it}: residual {total_res:.4f}")
                break
            prev_res = total_res
    print(f"[ColorOpt] {len(residuals)} iterations, residual first {residuals[0]!r} "
          f"last {residuals[-1]!r}")

    # --- bake vertex colors ----------------------------------------------------
    with substep("color_opt.bake"):
        acc = torch.zeros((verts.shape[0], 3), dtype=torch.float32, device=dev)
        cnt = torch.zeros(verts.shape[0], dtype=torch.float32, device=dev)
        for ids, st in zip(chunks, static):
            val, ok = _sample_rgb(verts, st["K"], poses(ids), stack(ids, "rgb"), st["vis"])
            acc = acc + val.sum(0)
            cnt = cnt + ok.sum(0).float()
        mesh = dataclasses.replace(
            mesh, vertex_colors=acc.cpu().numpy() / np.maximum(cnt.cpu().numpy(), 1.0)[:, None])

    # --- write refined poses back into per-side datasets -----------------------
    for side in Side:
        ds = color_dataset_map[side]
        positions = np.array(ds.transforms.positions, copy=True)
        rotations = np.array(ds.transforms.rotations, copy=True)
        for f in frames:
            if f["side"] != side:
                continue
            pose_cw = np.linalg.inv(f["T"])
            positions[f["idx"]] = pose_cw[:3, 3]
            rotations[f["idx"]] = np.asarray(quat.from_matrix(pose_cw[:3, :3]))
        ds.transforms = Transforms(CoordinateSystem.OPEN3D, positions, rotations)

    # Not a no-op: the first filter merges vertices at equal positions after
    # its triangle cleanup, so a triangle can turn degenerate or duplicated
    # there, and this pass removes it, as the JAX build's does.  Marching
    # cubes puts vertices of different lattice edges at one point where a
    # voxel's tsdf is so near 0 that `lattice + frac` rounds to the voxel.
    with substep("color_opt.filter"):
        mesh = filter_mesh_components(mesh, min_triangle_count=config.min_triangle_count,
                                      device=dev)
    return mesh, color_dataset_map
