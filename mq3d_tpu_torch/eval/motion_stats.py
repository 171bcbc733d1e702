"""HMD / controller motion statistics; the counterpart of
mq3d_tpu/eval/motion_stats.py (host numpy, the same code).

Re-design of the reference's study-analysis tools (reference:
analysis/computation/compute_hmd_motion_stats.py:56-619 and
compute_controller_motion_stats.py:56-610): translation/rotation dynamics,
acceleration, workspace volume, jitter, viewing-sphere coverage with the
headset FOV, cumulative pitch/yaw scanning, and inter-hand coordination.
Everything is vectorized numpy over the full pose track, and the summary
rows share the reference's CSV column contract so the analysis scripts
consume them directly.  pandas is imported only by stats_from_pose_csv.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from mq3d_tpu_torch.geometry import quaternion as quat

HMD_FOV_DEG = 73.1  # reference compute_hmd_motion_stats.py:168-211


@dataclass
class MotionStats:
    duration_s: float
    total_distance_m: float
    mean_speed_mps: float
    max_speed_mps: float
    total_rotation_deg: float
    mean_angular_speed_dps: float
    yaw_range_deg: float
    pitch_range_deg: float
    roll_range_deg: float
    workspace_volume_m3: float
    position_jitter_m: float
    viewing_sphere_coverage: float
    viewing_sphere_coverage_fov: float
    # extended set (reference summary columns)
    n_samples: int = 0
    sampling_hz: float = 0.0
    net_displacement_m: float = 0.0
    peak_angular_speed_dps: float = 0.0
    cumulative_pitch_deg: float = 0.0  # vertical scanning
    cumulative_yaw_deg: float = 0.0  # horizontal scanning
    mean_accel_ms2: float = 0.0
    peak_accel_ms2: float = 0.0


def _euler_zyx(quats: np.ndarray) -> np.ndarray:
    """xyzw quats -> (N, 3) yaw/pitch/roll (z-y-x intrinsic), degrees."""
    x, y, z, w = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    return np.degrees(np.stack([yaw, pitch, roll], -1))


def _sphere_coverage(directions: np.ndarray, fov_deg: Optional[float], n_samples: int = 2000) -> float:
    """Fraction of the unit sphere covered by view directions, optionally
    dilated by half the FOV cone (reference :168-211)."""
    if len(directions) == 0:
        return 0.0
    # Fibonacci sphere sample points.
    i = np.arange(n_samples) + 0.5
    phi = np.arccos(1 - 2 * i / n_samples)
    theta = np.pi * (1 + 5 ** 0.5) * i
    samples = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1
    )
    d = directions / np.maximum(np.linalg.norm(directions, axis=-1, keepdims=True), 1e-12)
    cos_thresh = np.cos(np.radians(fov_deg / 2.0)) if fov_deg else np.cos(np.radians(1.0))
    covered = (samples @ d.T).max(axis=1) >= cos_thresh
    return float(covered.mean())


def _unwrap_deg(a: np.ndarray) -> np.ndarray:
    return np.degrees(np.unwrap(np.radians(a)))


def compute_motion_stats(
    timestamps: np.ndarray,  # seconds or ms (auto-detected)
    positions: np.ndarray,  # (N, 3)
    rotations: np.ndarray,  # (N, 4) xyzw
    forward_axis: np.ndarray = np.array([0.0, 0.0, 1.0]),
) -> MotionStats:
    t = np.asarray(timestamps, np.float64)
    if len(t) > 1 and np.median(np.diff(t)) > 1.0:
        t = t / 1000.0  # ms -> s
    dt = np.diff(t)
    dt = np.where(dt > 0, dt, np.nan)

    pos = np.asarray(positions, np.float64)
    step = np.linalg.norm(np.diff(pos, axis=0), axis=-1)
    speed = step / dt
    total_distance = float(np.nansum(step))
    duration = float(t[-1] - t[0]) if len(t) > 1 else 0.0
    net_disp = float(np.linalg.norm(pos[-1] - pos[0])) if len(pos) > 1 else 0.0

    # acceleration from consecutive speeds
    if len(speed) > 1:
        accel = np.abs(np.diff(speed)) / dt[1:]
        mean_accel = float(np.nanmean(accel))
        peak_accel = float(np.nanmax(accel))
    else:
        mean_accel = peak_accel = 0.0

    q = np.asarray(rotations, np.float64)
    # Relative rotation angles between consecutive frames.
    rel = np.asarray(quat.multiply(quat.conjugate(q[:-1]), q[1:]))
    ang = 2 * np.arccos(np.clip(np.abs(rel[:, 3]), -1, 1))
    total_rotation = float(np.degrees(np.nansum(ang)))
    ang_speed = np.degrees(ang) / dt

    euler = _euler_zyx(q)
    ranges = euler.max(0) - euler.min(0)
    # Cumulative scanning: total absolute yaw/pitch travel (unwrapped).
    if len(euler) > 1:
        cum_yaw = float(np.nansum(np.abs(np.diff(_unwrap_deg(euler[:, 0])))))
        cum_pitch = float(np.nansum(np.abs(np.diff(euler[:, 1]))))
    else:
        cum_yaw = cum_pitch = 0.0

    extent = pos.max(0) - pos.min(0) if len(pos) else np.zeros(3)
    workspace = float(np.prod(np.maximum(extent, 0)))

    # Jitter: residual after a 5-sample moving average.
    if len(pos) >= 5:
        kernel = np.ones(5) / 5
        smooth = np.stack(
            [np.convolve(pos[:, k], kernel, mode="same") for k in range(3)], -1
        )
        jitter = float(np.linalg.norm(pos[2:-2] - smooth[2:-2], axis=-1).mean())
    else:
        jitter = 0.0

    fwd = np.asarray(quat.rotate(q, forward_axis))
    coverage = _sphere_coverage(fwd, fov_deg=None)
    coverage_fov = _sphere_coverage(fwd, fov_deg=HMD_FOV_DEG)

    return MotionStats(
        duration_s=duration,
        total_distance_m=total_distance,
        mean_speed_mps=float(np.nanmean(speed)) if len(speed) else 0.0,
        max_speed_mps=float(np.nanmax(speed)) if len(speed) else 0.0,
        total_rotation_deg=total_rotation,
        mean_angular_speed_dps=float(np.nanmean(ang_speed)) if len(ang_speed) else 0.0,
        yaw_range_deg=float(ranges[0]),
        pitch_range_deg=float(ranges[1]),
        roll_range_deg=float(ranges[2]),
        workspace_volume_m3=workspace,
        position_jitter_m=jitter,
        viewing_sphere_coverage=coverage,
        viewing_sphere_coverage_fov=coverage_fov,
        n_samples=len(t),
        sampling_hz=float((len(t) - 1) / duration) if duration > 0 else 0.0,
        net_displacement_m=net_disp,
        peak_angular_speed_dps=float(np.nanmax(ang_speed)) if len(ang_speed) else 0.0,
        cumulative_pitch_deg=cum_pitch,
        cumulative_yaw_deg=cum_yaw,
        mean_accel_ms2=mean_accel,
        peak_accel_ms2=peak_accel,
    )


def stats_from_pose_csv(csv_path) -> MotionStats:
    import pandas as pd

    df = pd.read_csv(csv_path, on_bad_lines="skip").dropna()
    df = df.sort_values("unix_time")
    return compute_motion_stats(
        df["unix_time"].to_numpy() / 1000.0,
        df[["pos_x", "pos_y", "pos_z"]].to_numpy(),
        df[["rot_x", "rot_y", "rot_z", "rot_w"]].to_numpy(),
    )


# ---------------------------------------------------------------------------
# Summary rows: the CSV column contract shared with the analysis scripts
# ---------------------------------------------------------------------------

def hmd_summary_row(
    stats: MotionStats,
    capture_name: str,
    capture_path: str,
    participant: Optional[str] = None,
    condition: Optional[str] = None,
) -> Dict:
    """One hmd_all_summary.csv row (reference compute_hmd_motion_stats
    summary schema; analyze_hmd_motion_stats.py:69-84 consumes it)."""
    return {
        "capture_name": capture_name,
        "capture_path": capture_path,
        "participant": participant,
        "condition": condition,
        "num_samples": stats.n_samples,
        "duration_seconds": stats.duration_s,
        "sampling_hz": stats.sampling_hz,
        "body_distance_m": stats.total_distance_m,
        "body_net_displacement_m": stats.net_displacement_m,
        "body_avg_speed_kmh": stats.mean_speed_mps * 3.6,
        "body_peak_speed_kmh": stats.max_speed_mps * 3.6,
        "head_cumulative_radians": np.radians(stats.total_rotation_deg),
        "head_avg_angular_speed_rad_s": np.radians(stats.mean_angular_speed_dps),
        "head_peak_angular_speed_rad_s": np.radians(stats.peak_angular_speed_dps),
        "yaw_range_rad": np.radians(stats.yaw_range_deg),
        "pitch_range_rad": np.radians(stats.pitch_range_deg),
        "roll_range_rad": np.radians(stats.roll_range_deg),
        "cumulative_vertical_rotation_rad": np.radians(stats.cumulative_pitch_deg),
        "cumulative_horizontal_rotation_rad": np.radians(stats.cumulative_yaw_deg),
        "viewing_sphere_coverage_percent": stats.viewing_sphere_coverage * 100.0,
        "viewing_sphere_coverage_with_fov_percent":
            stats.viewing_sphere_coverage_fov * 100.0,
    }


def controller_summary_row(
    stats: MotionStats,
    capture_name: str,
    capture_path: str,
    hand: str,
    participant: Optional[str] = None,
    condition: Optional[str] = None,
) -> Dict:
    """One per-hand controller summary row (reference
    compute_controller_motion_stats HandSummary schema;
    analyze_controller_motion_stats.py:64-76 consumes it)."""
    return {
        "capture_name": capture_name,
        "capture_path": capture_path,
        "participant": participant,
        "condition": condition,
        "hand": hand,
        "num_samples": stats.n_samples,
        "duration_seconds": stats.duration_s,
        "total_distance_m": stats.total_distance_m,
        "net_displacement_m": stats.net_displacement_m,
        "avg_speed_kmh": stats.mean_speed_mps * 3.6,
        "peak_speed_kmh": stats.max_speed_mps * 3.6,
        "avg_acceleration_ms2": stats.mean_accel_ms2,
        "peak_acceleration_ms2": stats.peak_accel_ms2,
        "cumulative_rotation_rad": np.radians(stats.total_rotation_deg),
        "avg_angular_speed_rad_s": np.radians(stats.mean_angular_speed_dps),
        "peak_angular_speed_rad_s": np.radians(stats.peak_angular_speed_dps),
        "workspace_volume_m3": stats.workspace_volume_m3,
        "jitter_stddev_m": stats.position_jitter_m,
    }


def inter_hand_stats(
    left_t: np.ndarray,
    left_pos: np.ndarray,
    right_t: np.ndarray,
    right_pos: np.ndarray,
) -> Dict:
    """Inter-hand coordination metrics on the overlapping time range
    (reference compute_controller_motion_stats.py:356-470: nearest-sample
    alignment on the left timebase, ~90 Hz dt approximation for km/h,
    speed-correlation, and sync = 1/(1 + avg_rel_speed/10))."""
    zeros = {
        "avg_inter_hand_distance_m": 0.0,
        "min_inter_hand_distance_m": 0.0,
        "max_inter_hand_distance_m": 0.0,
        "inter_hand_distance_stddev_m": 0.0,
        "avg_relative_speed_kmh": 0.0,
        "peak_relative_speed_kmh": 0.0,
        "movement_correlation": 0.0,
        "synchronization_score": 0.0,
    }
    lo = max(left_t.min(), right_t.min()) if len(left_t) and len(right_t) else 1
    hi = min(left_t.max(), right_t.max()) if len(left_t) and len(right_t) else 0
    if lo >= hi:
        return zeros
    lm = (left_t >= lo) & (left_t <= hi)
    rm = (right_t >= lo) & (right_t <= hi)
    lp = np.asarray(left_pos, np.float64)[lm]
    rp = np.asarray(right_pos, np.float64)[rm]
    rt = np.asarray(right_t, np.float64)[rm]
    lt = np.asarray(left_t, np.float64)[lm]
    if len(lp) < 2 or len(rp) < 2:
        return zeros
    # Nearest right sample per left timestamp (reference :396-403).
    # searchsorted, not a full (L, R) difference matrix — at 90 Hz over
    # minutes that matrix is tens of GB; this is O((L+R) log R) time,
    # O(L) memory.  Right timestamps are monotone (capture order); sort
    # defensively in case a trim tool reordered them.
    order = np.argsort(rt, kind="stable")
    rt_s, rp_s = rt[order], rp[order]
    hi_i = np.searchsorted(rt_s, lt)
    lo_i = np.clip(hi_i - 1, 0, len(rt_s) - 1)
    hi_i = np.clip(hi_i, 0, len(rt_s) - 1)
    pick_hi = np.abs(rt_s[hi_i] - lt) < np.abs(lt - rt_s[lo_i])
    idx = np.where(pick_hi, hi_i, lo_i)
    rp_i = rp_s[idx]

    dist = np.linalg.norm(lp - rp_i, axis=1)
    ld = np.diff(lp, axis=0)
    rd = np.diff(rp_i, axis=0)
    rel_speed_kmh = np.linalg.norm(ld - rd, axis=1) * 90.0 * 3.6
    ls = np.linalg.norm(ld, axis=1)
    rs = np.linalg.norm(rd, axis=1)
    corr = 0.0
    if ls.std() > 0 and rs.std() > 0:
        c = np.corrcoef(ls, rs)[0, 1]
        corr = float(c) if np.isfinite(c) else 0.0
    avg_rel = float(rel_speed_kmh.mean())
    return {
        "avg_inter_hand_distance_m": float(dist.mean()),
        "min_inter_hand_distance_m": float(dist.min()),
        "max_inter_hand_distance_m": float(dist.max()),
        "inter_hand_distance_stddev_m": float(dist.std()),
        "avg_relative_speed_kmh": avg_rel,
        "peak_relative_speed_kmh": float(rel_speed_kmh.max()),
        "movement_correlation": corr,
        "synchronization_score": float(np.clip(1.0 / (1.0 + avg_rel / 10.0),
                                               0.0, 1.0)),
    }
