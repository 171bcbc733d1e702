"""The generator of a Quest session, named `quest_session` by a traffic
file: a furnished box room seen from two orbiting depth cameras, made on
the device from the traffic file's parameters and a seed.

A rewrite of the port's synthetic capture (an analytic box room with solid
boxes inside, Quest-scale intrinsics given as FOV tangents with a mildly
asymmetric horizontal FOV, a yaw orbit near the room centre) in plain
PyTorch, so the yardstick does not move with the program.  Nothing is
written to disk: the depth frames are rendered on the device in float64
and kept as float32 metric z-depth, 0 where the ray leaves the far clip.

The seed moves the scene, never its sizes: the orbit's phase, radius and
centre, and each clutter box along the floor, within the traffic's
jitters.  The second side is the first side's orbit seen from a camera
`stereo_baseline_m` to its right.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Session:
    depth: torch.Tensor  # (N, H, W) float32 metric z-depth on the device, 0 = invalid
    K_depth: np.ndarray  # (N, 3, 3) float32, cx mirror-flipped (what projections use)
    T_cw: np.ndarray  # (N, 4, 4) float64 camera-to-world, OPEN3D camera frame
    side: np.ndarray  # (N,) int side of each frame; frames are side-major
    frames_per_side: int

    def side_slice(self, s: int) -> slice:
        return slice(s * self.frames_per_side, (s + 1) * self.frames_per_side)


def flipped_intrinsics(tangents: dict, w: int, h: int) -> np.ndarray:
    """3x3 pinhole matrix from FOV tangents, with cx mirror-flipped (w - cx)
    as the pipeline renders and integrates."""
    span_x = tangents["left"] + tangents["right"]
    span_y = tangents["top"] + tangents["bottom"]
    fx, fy = w / span_x, h / span_y
    cx = w * tangents["right"] / span_x
    cy = h * tangents["top"] / span_y
    return np.array([[fx, 0.0, w - cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)


def _look_rotations(forward: np.ndarray) -> np.ndarray:
    """(n, 3, 3) camera-to-world rotations of OPEN3D cameras (x right, y down,
    z forward) looking along `forward` (n, 3) in a y-up world."""
    z = forward / np.linalg.norm(forward, axis=-1, keepdims=True)
    down = np.broadcast_to(np.array([0.0, -1.0, 0.0]), z.shape)
    x = np.cross(down, z)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1)


def orbit_poses(traffic: dict, rng: np.random.Generator) -> np.ndarray:
    """(sides * frames_per_side, 4, 4) float64 camera-to-world poses."""
    n = int(traffic["frames_per_side"])
    lo, hi = np.asarray(traffic["room_min"]), np.asarray(traffic["room_max"])
    phase = rng.uniform(0.0, 2.0 * math.pi)
    radius = traffic["orbit_radius_m"] + rng.uniform(-1.0, 1.0) * traffic["orbit_radius_jitter_m"]
    cj = traffic["orbit_center_jitter_m"]
    center = (lo + hi) / 2.0 + np.array([rng.uniform(-cj, cj), 0.0, rng.uniform(-cj, cj)])
    a = phase + np.linspace(0.0, traffic["orbit_sweep_rad"], n, endpoint=False)
    pos = np.stack([center[0] + radius * np.cos(a),
                    center[1] + traffic["orbit_height_wobble_m"] * np.sin(2 * a),
                    center[2] + radius * np.sin(a)], axis=-1)
    rot = _look_rotations(np.stack([np.cos(a), traffic["orbit_pitch"] * np.sin(a),
                                    np.sin(a)], axis=-1))
    poses = []
    for s in range(int(traffic["sides"])):
        T = np.tile(np.eye(4), (n, 1, 1))
        T[:, :3, :3] = rot
        T[:, :3, 3] = pos + s * traffic["stereo_baseline_m"] * rot[:, :, 0]
        poses.append(T)
    return np.concatenate(poses)


def jittered_clutter(traffic: dict, rng: np.random.Generator) -> np.ndarray:
    """(B, 2, 3) solid boxes, each moved along the floor (x and z) by the
    seed: uniformly within `clutter_jitter_m` and the room, so a box at a
    wall moves away from it.  No face keeps its listed coordinate, which
    may lie on a block boundary of the volume's grid."""
    boxes = np.asarray(traffic["clutter"], np.float64).reshape(-1, 2, 3)
    lo, hi = np.asarray(traffic["room_min"]), np.asarray(traffic["room_max"])
    j = traffic["clutter_jitter_m"]
    out = boxes.copy()
    for b in range(len(boxes)):
        for a in (0, 2):
            out[b, :, a] += rng.uniform(max(-j, lo[a] - boxes[b, 0, a]),
                                        min(j, hi[a] - boxes[b, 1, a]))
    return out


def render_depth(T_cw: torch.Tensor, K: np.ndarray, w: int, h: int, room_lo, room_hi,
                 clutter: torch.Tensor, far_clip: float) -> torch.Tensor:
    """(B, h, w) float32 z-depth of the room interior and its solid boxes
    from cameras T_cw (B, 4, 4) float64 on the device.  Pixel (u, v) casts
    the ray ((u - cx')/fx, (v - cy)/fy, 1); 0 where nothing lies within
    `far_clip`."""
    dev = T_cw.device
    f64 = dict(dtype=torch.float64, device=dev)
    u = torch.arange(w, **f64)[None, :].expand(h, w)
    v = torch.arange(h, **f64)[:, None].expand(h, w)
    cam = torch.stack([(u - float(K[0, 2])) / float(K[0, 0]),
                       (v - float(K[1, 2])) / float(K[1, 1]), torch.ones_like(u)], -1)
    d = torch.einsum("hwj,bij->bhwi", cam, T_cw[:, :3, :3])  # (B, h, w, 3)
    c = T_cw[:, :3, 3][:, None, None, :]
    inf = torch.full((), math.inf, **f64)
    t_hit = torch.full(d.shape[:-1], math.inf, **f64)
    lo = torch.tensor(room_lo, **f64)
    hi = torch.tensor(room_hi, **f64)
    for axis in range(3):
        for bound in (lo[axis], hi[axis]):
            t = (bound - c[..., axis]) / d[..., axis]
            t = torch.where(torch.isfinite(t) & (t > 1e-9), t, inf)
            t_safe = torch.where(torch.isfinite(t), t, torch.zeros((), **f64))
            on_face = torch.ones_like(t, dtype=torch.bool)
            for a in range(3):
                if a != axis:
                    p = c[..., a] + t_safe * d[..., a]
                    on_face &= (p >= lo[a] - 1e-9) & (p <= hi[a] + 1e-9)
            t_hit = torch.minimum(t_hit, torch.where(on_face, t, inf))
    for b in range(clutter.shape[0]):
        t_in = t_out = None
        for a in range(3):
            t0 = (clutter[b, 0, a] - c[..., a]) / d[..., a]
            t1 = (clutter[b, 1, a] - c[..., a]) / d[..., a]
            near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
            t_in = near if t_in is None else torch.fmax(t_in, near)
            t_out = far if t_out is None else torch.fmin(t_out, far)
        hit = (t_in <= t_out) & (t_in > 1e-9)
        t_hit = torch.minimum(t_hit, torch.where(hit, t_in, inf))
    z = torch.where(t_hit <= far_clip, t_hit, torch.zeros((), **f64))
    return z.float()


def make(traffic: dict, seed: int, device, frames_per_call: int = 100) -> Session:
    """The session of `traffic` for `seed`, its depth rendered on `device`."""
    rng = np.random.default_rng(int(seed))
    T_cw = orbit_poses(traffic, rng)
    clutter = jittered_clutter(traffic, rng)
    w, h = int(traffic["depth_width"]), int(traffic["depth_height"])
    K = flipped_intrinsics(traffic["fov_tangents"], w, h)
    dev = torch.device(device)
    T_dev = torch.from_numpy(T_cw).to(dev)
    clutter_dev = torch.from_numpy(clutter).to(dev)
    depth = torch.cat([
        render_depth(T_dev[i:i + frames_per_call], K, w, h, traffic["room_min"],
                     traffic["room_max"], clutter_dev, float(traffic["far_clip_m"]))
        for i in range(0, len(T_cw), frames_per_call)])
    n_side = int(traffic["frames_per_side"])
    return Session(
        depth=depth,
        K_depth=np.broadcast_to(K, (len(T_cw), 3, 3)).copy(),
        T_cw=T_cw,
        side=np.repeat(np.arange(int(traffic["sides"])), n_side),
        frames_per_side=n_side,
    )
