"""Analytic scenes for the raycast's tests: planes seen by a 320x240 pinhole
camera, their exact z-depth, and TSDF volumes the port integrates from it.

These are the thin slab, the wall near depth_max and the grazing plane of
the JAX package's tests/test_raycast_adversarial.py, at its 1 cm voxels.
`SCENES[name]()` gives (planes, integration poses, view): each plane is
(point, normal, bounds or None) and each pose a world-to-camera 4x4.
"""

from __future__ import annotations

import numpy as np

from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.geometry.coordinates import CoordinateSystem
from mq3d_tpu_torch.models.datasets import CameraDataset
from mq3d_tpu_torch.models.transforms import Transforms
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume

W, H = 320, 240
FX = FY = 260.0
K_ADV = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1]], np.float32)
CFG_ADV = TSDFConfig(voxel_size=0.01, block_resolution=16, block_count=16384, grid_dim=64,
                     depth_max=4.0, trunc_voxel_multiplier=10.0,
                     chunk_active_capacity=8192, integrate_tile=256)


def rays() -> np.ndarray:
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    return np.stack([(u - K_ADV[0, 2]) / FX, (v - K_ADV[1, 2]) / FY, np.ones_like(u)], -1)


def lookat_T_wc(eye, target, up=(0, -1, 0)) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T_cw = np.eye(4)
    T_cw[:3, 0], T_cw[:3, 1], T_cw[:3, 2], T_cw[:3, 3] = x, y, z, eye
    return np.linalg.inv(T_cw)


def plane_depth(T_wc, p0, n, bounds=None) -> np.ndarray:
    T_cw = np.linalg.inv(T_wc)
    dirs_w = rays() @ T_cw[:3, :3].T
    n = np.asarray(n, np.float64)
    denom = dirs_w @ n
    num = n @ (np.asarray(p0, np.float64) - T_cw[:3, 3])
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = num / denom
    hit = (denom != 0) & (tt > 0)
    if bounds is not None:
        b = np.asarray(bounds, np.float64)
        pw = T_cw[:3, 3] + tt[..., None] * dirs_w
        hit &= np.all((pw >= b[:, 0] - 1e-9) & (pw <= b[:, 1] + 1e-9), -1)
    return np.where(hit, tt, np.inf)


def scene_depth(T_wc, planes) -> np.ndarray:
    return np.min(np.stack([plane_depth(T_wc, *p) for p in planes]), axis=0)


def integrate_planes(planes, poses, device="cpu") -> TSDFVolume:
    """The planes' exact depth from each pose, integrated into a fresh
    CFG_ADV volume on `device`."""
    depth = np.stack([scene_depth(T, planes) for T in poses]).astype(np.float32)
    depth[~np.isfinite(depth)] = 0.0
    vol = TSDFVolume(CFG_ADV, device=device)
    vol.integrate(depth, np.tile(K_ADV[None], (len(poses), 1, 1)),
                  np.stack(poses).astype(np.float32), np.ones(len(poses), bool))
    return vol


def central(gt, far=np.inf) -> np.ndarray:
    c = np.zeros((H, W), bool)
    c[H // 6: -H // 6, W // 6: -W // 6] = True
    return c & np.isfinite(gt) & (gt < far)


def thin_slab():
    """A 2 cm slab 1.5 m away in front of a wall at 2.5 m."""
    slab = ([0, 0, 1.5], [0, 0, -1.0], [[-0.15, 0.15], [-0.20, 0.20], [1.49, 1.51]])
    planes = [slab, ([0, 0, 2.5], [0, 0, -1.0], None)]
    poses = [lookat_T_wc((x, y, 0.0), (0, 0, 1.5)) for x in (-0.15, 0.0, 0.15)
             for y in (-0.1, 0.1)]
    return planes, poses, lookat_T_wc((0.02, 0.01, 0.0), (0, 0, 1.5))


def depth_max_wall():
    """A wall at 3.9 m, just inside depth_max."""
    wall = ([0, 0, 3.9], [0, 0, -1.0], None)
    poses = [lookat_T_wc((x, y, 0.0), (0, 0, 3.9)) for x in (-0.2, 0.0, 0.2)
             for y in (-0.15, 0.15)]
    return [wall], poses, lookat_T_wc((0.03, -0.02, 0.0), (0, 0, 3.9))


def grazing_plane():
    """A plane at 78 degrees to the view axis, bounded in depth to [0.6, 3.4] m."""
    n = np.array([np.sin(np.deg2rad(78.0)), 0, -np.cos(np.deg2rad(78.0))])
    plane = ([0, 0, 2.0], n, [[-2.0, 2.0], [-2.0, 2.0], [0.6, 3.4]])
    poses = [lookat_T_wc((x, y, 0.0), (0, 0, 2.0)) for x in (-0.1, 0.0, 0.1)
             for y in (-0.1, 0.1)]
    return [plane], poses, lookat_T_wc((0.02, 0.03, 0.0), (0, 0, 2.0))


SCENES = {"thin_slab": thin_slab, "depth_max_wall": depth_max_wall,
          "grazing_plane": grazing_plane}


def wall_views():
    """A wall at 3 m and three views of it 5 cm apart: (planes, integration
    poses, views)."""
    wall = ([0, 0, 3.0], [0, 0, -1.0], None)
    poses = [lookat_T_wc((x, y, 0.0), (0, 0, 3.0)) for x in (-0.2, 0.0, 0.2)
             for y in (-0.15, 0.15)]
    return [wall], poses, [lookat_T_wc((x, 0.01, 0.0), (0, 0, 3.0)) for x in (-0.05, 0.0, 0.05)]


def camera_dataset(views) -> CameraDataset:
    """A CameraDataset of W x H views at K_ADV from world-to-camera poses
    (OPEN3D frame), as `raycast_in_color_view` takes them."""
    T_cw = np.linalg.inv(np.stack(views))
    n = len(views)
    ones = np.ones(n)
    return CameraDataset(
        directory_relative_path="t",
        image_file_names=np.array([f"{i}.png" for i in range(n)]),
        timestamps=np.arange(n, dtype=np.int64),
        fx=FX * ones, fy=FY * ones, cx=K_ADV[0, 2] * ones, cy=K_ADV[1, 2] * ones,
        transforms=Transforms(coordinate_system=CoordinateSystem.OPEN3D,
                              positions=T_cw[:, :3, 3].astype(np.float32),
                              rotations=quat.from_matrix(T_cw[:, :3, :3])),
        widths=np.full(n, W, np.int64), heights=np.full(n, H, np.int64))
