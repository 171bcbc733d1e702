"""Synthetic QRC capture writer: an analytic box room with known geometry.

The port's own counterpart of mq3d_tpu/testing/synthetic.py, with the
standard library and numpy only (no pandas, no cv2): raw NDC depth +
descriptor CSVs, I420 YUV frames + format/characteristics JSONs and the HMD
pose CSV, rendered analytically from inside an axis-aligned box, in the
reference's on-disk layout.  Same scene, poses and conventions as the JAX
build's writer; its BGR -> I420 step is a numpy BT.601 conversion and is
not byte-identical to cv2's (parity tests use the JAX build's writer).

Conventions: ground-truth camera poses are authored in the OPEN3D frame and
converted backward to the UNITY logging frame, exactly inverting what the
pipeline does on load.  Intrinsics are FOV tangents with a mildly
asymmetric horizontal FOV so the cx-mirror-flip path is exercised.
"""

from __future__ import annotations

import csv
import json
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Tuple

import numpy as np

from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem, Transforms
from mq3d_tpu_torch.ops.depth import ndc_to_linear_params

# Box interior (OPEN3D world frame, meters).
DEFAULT_BOX_MIN = np.array([-2.0, -1.2, -2.0])
DEFAULT_BOX_MAX = np.array([2.0, 1.2, 2.0])
X180 = np.array([1.0, 0.0, 0.0, 0.0])  # 180 deg about x, xyzw


@dataclass
class SyntheticSceneConfig:
    n_frames: int = 24
    depth_width: int = 80
    depth_height: int = 64
    color_width: int = 96
    color_height: int = 72
    near: float = 0.1
    far: float = 5.0
    fov_left: float = 1.1
    fov_right: float = 0.9
    fov_top: float = 0.8
    fov_bottom: float = 0.8
    sweep: float = 2.0 * np.pi  # yaw range of the orbit (radians)
    box_min: np.ndarray = field(default_factory=lambda: DEFAULT_BOX_MIN.copy())
    box_max: np.ndarray = field(default_factory=lambda: DEFAULT_BOX_MAX.copy())
    t0_ms: int = 1_000_000
    # Solid axis-aligned boxes inside the room, ((min xyz), (max xyz)) each.
    clutter: tuple = ()


# Furniture for the box room (OPEN3D world, y up, floor at y = -1.2): a
# cabinet and a shelf on the +x wall, a low table at the -x wall, boxes at
# the +z and -z walls.  Their faces give every half of the orbit surfaces
# facing along y and z where the halves overlap, at the +-x walls; the
# walls alone are parallel planes there, along which fragment ICP slides.
ROOM_CLUTTER = (
    ((1.5, -1.2, -0.9), (2.0, 0.2, -0.1)),
    ((1.7, 0.5, 0.3), (2.0, 0.8, 1.3)),
    ((-2.0, -1.2, 0.2), (-1.4, -0.4, 1.2)),
    ((-0.6, -1.2, 1.3), (0.4, -0.6, 2.0)),
    ((0.8, -1.2, -2.0), (1.6, -0.2, -1.5)),
)


def quest_scene(n_frames: int = 60, clutter: tuple = ()) -> SyntheticSceneConfig:
    """The box room at Quest scale: 320x288 depth (bench.py's capture) and
    1280x960 colour, with `clutter` boxes inside (ROOM_CLUTTER: furnished)."""
    return SyntheticSceneConfig(n_frames=n_frames, depth_width=320, depth_height=288,
                                color_width=1280, color_height=960, clutter=clutter)


def look_rotation_o3d(forward: np.ndarray) -> np.ndarray:
    """Camera-to-world rotation for an OPEN3D camera (X-right, Y-down,
    Z-forward) looking along `forward` in an OPEN3D Y-up world."""
    z = forward / np.linalg.norm(forward)
    down = np.array([0.0, -1.0, 0.0])
    if abs(np.dot(z, down)) > 0.99:
        down = np.array([0.0, 0.0, -1.0])
    x = np.cross(down, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1)


def orbit_poses_o3d(cfg: SyntheticSceneConfig) -> Transforms:
    """Ground-truth OPEN3D camera-to-world poses: a yaw sweep from near the
    room centre with a small positional orbit, covering all four walls."""
    n = cfg.n_frames
    angles = np.linspace(0.0, cfg.sweep, n, endpoint=False)
    radius = 0.3
    center = (cfg.box_min + cfg.box_max) / 2.0
    positions = np.stack(
        [
            center[0] + radius * np.cos(angles),
            center[1] + 0.1 * np.sin(2 * angles),
            center[2] + radius * np.sin(angles),
        ],
        axis=-1,
    )
    rots = [np.asarray(quat.from_matrix(look_rotation_o3d(
        np.array([np.cos(a), 0.15 * np.sin(a), np.sin(a)])))) for a in angles]
    return Transforms(CoordinateSystem.OPEN3D, positions, np.stack(rots))


def intrinsics_from_cfg(cfg: SyntheticSceneConfig, w: int, h: int):
    fx = w / (cfg.fov_right + cfg.fov_left)
    fy = h / (cfg.fov_top + cfg.fov_bottom)
    cx = w * cfg.fov_right / (cfg.fov_right + cfg.fov_left)
    cy = h * cfg.fov_top / (cfg.fov_top + cfg.fov_bottom)
    return fx, fy, cx, cy


def _camera_rays(fx, fy, cx_flipped, cy, w, h) -> np.ndarray:
    u = np.arange(w, dtype=np.float64)[None, :]
    v = np.arange(h, dtype=np.float64)[:, None]
    return np.stack([np.broadcast_to((u - cx_flipped) / fx, (h, w)),
                     np.broadcast_to((v - cy) / fy, (h, w)),
                     np.ones((h, w))], -1)


def render_box_depth(pose_cw_o3d, fx, fy, cx_flipped, cy, w, h, box_min, box_max,
                     clutter: tuple = ()):
    """Analytic z-depth of the box interior seen from inside, and of the
    solid `clutter` boxes in it.  Pixel (u, v) maps to the camera ray
    ((u - cx')/fx, (v - cy)/fy, 1), cx' being the mirror-flipped principal
    point the pipeline uses."""
    d_world = _camera_rays(fx, fy, cx_flipped, cy, w, h) @ pose_cw_o3d[:3, :3].T
    c = pose_cw_o3d[:3, 3]
    t_exit = np.full((h, w), np.inf)
    for axis in range(3):
        for bound in (box_min[axis], box_max[axis]):
            denom = d_world[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (bound - c[axis]) / denom
            t = np.where(np.isfinite(t) & (t > 1e-9), t, np.inf)
            t_safe = np.where(np.isfinite(t), t, 0.0)
            p = c + t_safe[..., None] * d_world
            on_face = np.ones((h, w), dtype=bool)
            for a in (a for a in range(3) if a != axis):
                on_face &= (p[..., a] >= box_min[a] - 1e-9) & (p[..., a] <= box_max[a] + 1e-9)
            t_exit = np.minimum(t_exit, np.where(on_face, t, np.inf))
    for lo, hi in clutter:  # slab test: the entry point of each solid box
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (np.asarray(lo) - c) / d_world
            t1 = (np.asarray(hi) - c) / d_world
        t_in = np.nanmax(np.minimum(t0, t1), axis=-1)
        t_out = np.nanmin(np.maximum(t0, t1), axis=-1)
        hit = (t_in <= t_out) & (t_in > 1e-9)
        t_exit = np.minimum(t_exit, np.where(hit, t_in, np.inf))
    return t_exit  # z-depth == ray parameter because the ray's z is 1


def encode_ndc(z: np.ndarray, near: float, far: float) -> np.ndarray:
    """Invert the reference NDC->linear map z = x / (2 d - 1 + y)."""
    x, y = ndc_to_linear_params(near, far)
    x, y = float(np.asarray(x)), float(np.asarray(y))
    with np.errstate(divide="ignore"):
        d = ((x / z) - y + 1.0) / 2.0
    return np.where(np.isfinite(d), d, 0.0).astype(np.float32)


def bgr_to_i420(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> planar I420 bytes (H*3/2, W): BT.601
    studio-swing luma at full resolution, chroma averaged over 2x2 quads."""
    f = bgr.astype(np.float64)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
    u = 128.0 - 0.148223 * r - 0.290993 * g + 0.439216 * b
    v = 128.0 + 0.439216 * r - 0.367788 * g - 0.071427 * b
    h, w = y.shape

    def quad_mean(p):
        return p.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    planes = [np.clip(np.rint(p), 0, 255).astype(np.uint8)
              for p in (y, quad_mean(u), quad_mean(v))]
    return np.concatenate([p.ravel() for p in planes]).reshape(h * 3 // 2, w)


def _color_frame(pose_cw, cfg: SyntheticSceneConfig) -> np.ndarray:
    """I420 bytes of one colour frame: a smooth gradient of the hit point's
    position on the box walls."""
    w, h = cfg.color_width, cfg.color_height
    fx, fy, cx, cy = intrinsics_from_cfg(cfg, w, h)
    cx_flipped = w - cx
    z = render_box_depth(pose_cw, fx, fy, cx_flipped, cy, w, h, cfg.box_min, cfg.box_max,
                         cfg.clutter)
    pts = pose_cw[:3, 3] + z[..., None] * (_camera_rays(fx, fy, cx_flipped, cy, w, h)
                                           @ pose_cw[:3, :3].T)
    extent = cfg.box_max - cfg.box_min
    rgb = (np.clip((pts - cfg.box_min) / extent, 0.0, 1.0) * 255).astype(np.uint8)
    return bgr_to_i420(rgb[..., ::-1])


def write_synthetic_project(project_dir: Path, cfg: SyntheticSceneConfig | None = None,
                            workers: int = 1
                            ) -> Tuple[Path, SyntheticSceneConfig, Transforms]:
    """Create the full fake project dir.  Returns (dir, cfg, gt OPEN3D poses).
    `workers` threads render the colour frames (numpy releases the lock)."""
    cfg = cfg or SyntheticSceneConfig()
    project_dir = Path(project_dir)
    project_dir.mkdir(parents=True, exist_ok=True)

    gt_o3d = orbit_poses_o3d(cfg)
    gt_unity = gt_o3d.convert_coordinate_system(CoordinateSystem.UNITY, is_camera=True)
    timestamps = cfg.t0_ms + np.arange(cfg.n_frames) * 33
    poses_cw = gt_o3d.extrinsics_cw.astype(np.float64)

    # ---- depth: raw NDC files + descriptor CSVs (same for both sides) ------
    dfx, dfy, dcx, dcy = intrinsics_from_cfg(cfg, cfg.depth_width, cfg.depth_height)
    ndc_frames = [
        encode_ndc(render_box_depth(poses_cw[i], dfx, dfy, cfg.depth_width - dcx, dcy,
                                    cfg.depth_width, cfg.depth_height,
                                    cfg.box_min, cfg.box_max, cfg.clutter), cfg.near, cfg.far)
        for i in range(cfg.n_frames)
    ]
    header = ["timestamp_ms", "width", "height", "near_z", "far_z",
              "fov_left_angle_tangent", "fov_right_angle_tangent",
              "fov_top_angle_tangent", "fov_down_angle_tangent",
              "create_pose_location_x", "create_pose_location_y",
              "create_pose_location_z", "create_pose_rotation_x",
              "create_pose_rotation_y", "create_pose_rotation_z",
              "create_pose_rotation_w"]
    for side in Side:
        depth_dir = project_dir / f"{side.value}_depth"
        depth_dir.mkdir(exist_ok=True)
        with open(project_dir / f"{side.value}_depth_descriptors.csv", "w",
                  newline="") as f:
            out = csv.writer(f)
            out.writerow(header)
            for i, ts in enumerate(timestamps):
                ndc_frames[i].astype("<f4").tofile(depth_dir / f"{ts}.raw")
                out.writerow([int(ts), cfg.depth_width, cfg.depth_height,
                              repr(cfg.near), repr(cfg.far)]
                             + [repr(float(x)) for x in (
                                 cfg.fov_left, cfg.fov_right, cfg.fov_top,
                                 cfg.fov_bottom, *gt_unity.positions[i],
                                 *gt_unity.rotations[i])])

    # ---- HMD pose track ------------------------------------------------------
    # The pipeline mounts the colour camera on interpolated HMD poses via
    # camera = hmd o local; with an identity JSON pose the Android->HMD
    # fixups give local = x180, so hmd = cam_unity o x180^{-1}.  The track
    # is dense (2x frame rate) for interpolation coverage.
    hmd_rot = np.asarray(quat.multiply(gt_unity.rotations, quat.conjugate(X180)[None]))
    pose_rows = []
    for i, ts in enumerate(timestamps):
        pose_rows.append((ts, gt_unity.positions[i], hmd_rot[i]))
        if i + 1 < len(timestamps):
            mid_t = (timestamps[i] + timestamps[i + 1]) // 2
            mid_p = (gt_unity.positions[i] + gt_unity.positions[i + 1]) / 2
            mid_q = np.asarray(quat.slerp(hmd_rot[i], hmd_rot[i + 1], 0.5))
            pose_rows.append((mid_t, mid_p, mid_q))
    with open(project_dir / "hmd_poses.csv", "w") as f:
        f.write("unix_time,pos_x,pos_y,pos_z,rot_x,rot_y,rot_z,rot_w\n")
        for ts, p, q in pose_rows:
            f.write(f"{ts},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")

    # ---- colour: YUV frames (same for both sides) + JSONs ----------------------
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        frames = list(pool.map(lambda i: _color_frame(poses_cw[i], cfg),
                               range(cfg.n_frames)))
    w, h = cfg.color_width, cfg.color_height
    cfx, cfy, ccx, ccy = intrinsics_from_cfg(cfg, w, h)
    for side in Side:
        yuv_dir = project_dir / f"{side.value}_camera_raw"
        yuv_dir.mkdir(exist_ok=True)
        for ts, frame in zip(timestamps, frames):
            frame.tofile(yuv_dir / f"{ts}.yuv")
        fmt = {
            "width": w,
            "height": h,
            "format": "YUV_420_888",
            "planes": [
                {"bufferSize": w * h, "rowStride": w, "pixelStride": 1},
                {"bufferSize": (w // 2) * (h // 2), "rowStride": w // 2, "pixelStride": 1},
                {"bufferSize": (w // 2) * (h // 2), "rowStride": w // 2, "pixelStride": 1},
            ],
            "baseTime": {"baseMonoTimeNs": 0, "baseUnixTimeMs": 0},
        }
        with open(project_dir / f"{side.value}_camera_image_format.json", "w") as f:
            json.dump(fmt, f)
        chars = {
            "sensor": {"activeArraySize": {"left": 0, "top": 0, "right": w, "bottom": h}},
            "intrinsics": {"fx": cfx, "fy": cfy, "cx": ccx, "cy": ccy},
            "pose": {"translation": [0.0, 0.0, 0.0], "rotation": [0.0, 0.0, 0.0, 1.0]},
        }
        with open(project_dir / f"{side.value}_camera_characteristics.json", "w") as f:
            json.dump(chars, f)

    return project_dir, cfg, gt_o3d
