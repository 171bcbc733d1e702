"""HMD pose interpolation at arbitrary timestamps.

Re-design of the reference's per-timestamp dataframe scan (reference:
scripts/dataio/helpers/pose_interpolator.py:8-89) as one vectorized
searchsorted + lerp/slerp over the entire query batch: a 1000-frame color
dataset interpolates in a single call instead of 1000 dataframe filters.

Semantics preserved exactly:
  - 30 ms search window on each side (timestamps in microseconds)
  - endpoint extrapolation: outside the window on one side only, the nearest
    in-window pose is used verbatim
  - no pose within the window on either side -> invalid
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mq3d_tpu_torch.dataio.csv_io import parse_float
from mq3d_tpu_torch.geometry import quaternion as quat


class PoseInterpolator:
    def __init__(self, pose_csv_path: Path):
        self.pose_csv_path = Path(pose_csv_path)
        self._loaded = False
        self.times: np.ndarray = np.zeros(0, dtype=np.int64)
        self.positions: np.ndarray = np.zeros((0, 3))
        self.rotations: np.ndarray = np.zeros((0, 4))

    def _ensure_loaded(self):
        if self._loaded:
            return
        times, positions, rotations = _read_pose_csv(self.pose_csv_path)
        # Quicksort like the dataframe sort of the JAX build, so rows with
        # equal timestamps keep the same order there and here.
        order = np.argsort(times, kind="quicksort")
        self.times = times[order]
        self.positions = positions[order]
        self.rotations = rotations[order]
        self._loaded = True

    def interpolate_poses(
        self, timestamps: np.ndarray, window_ms: int = 30
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched interpolation.

        Returns (positions (N,3), rotations (N,4) xyzw, valid (N,) bool).
        """
        self._ensure_loaded()
        ts = np.asarray(timestamps, dtype=np.float64)
        window = window_ms * 1000.0  # ms -> us

        if len(self.times) == 0:
            n = len(ts)
            return np.zeros((n, 3)), np.zeros((n, 4)), np.zeros(n, dtype=bool)

        times = self.times.astype(np.float64)
        # prev: last pose with time <= ts;  next: first pose with time >= ts.
        idx_right = np.searchsorted(times, ts, side="right")
        prev_idx = np.clip(idx_right - 1, 0, len(times) - 1)
        has_prev = (idx_right > 0) & (np.abs(ts - times[prev_idx]) <= window)

        idx_left = np.searchsorted(times, ts, side="left")
        next_idx = np.clip(idx_left, 0, len(times) - 1)
        has_next = (idx_left < len(times)) & (np.abs(times[next_idx] - ts) <= window)

        valid = has_prev | has_next

        t0 = times[prev_idx]
        t1 = times[next_idx]
        denom = np.where(t1 != t0, t1 - t0, 1.0)
        alpha = np.where(t1 != t0, (ts - t0) / denom, 0.0)
        alpha = np.where(has_prev & has_next, alpha, np.where(has_prev, 0.0, 1.0))
        alpha = np.clip(alpha, 0.0, 1.0)[:, None]

        p0 = self.positions[prev_idx]
        p1 = self.positions[next_idx]
        positions = (1.0 - alpha) * p0 + alpha * p1

        q0 = self.rotations[prev_idx]
        q1 = self.rotations[next_idx]
        rotations = np.asarray(quat.slerp(q0, q1, alpha))

        return positions, rotations, valid

    def interpolate_pose(
        self, timestamp: int, window_ms: int = 30
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Single-timestamp convenience wrapper matching the reference API."""
        pos, rot, valid = self.interpolate_poses(
            np.asarray([timestamp]), window_ms=window_ms
        )
        if not valid[0]:
            return None
        return pos[0], rot[0]


# Cell texts that read as missing values (the CSV reader of the JAX build
# treats them as NaN and drops the row).
_NA_TEXT = {"", "nan", "NaN", "NAN", "NA", "N/A", "n/a", "null", "NULL",
            "None", "#N/A", "#NA", "-NaN", "-nan", "<NA>", "1.#IND", "1.#QNAN",
            "-1.#IND", "-1.#QNAN", "#N/A N/A"}


def _read_pose_csv(path: Path):
    """(times int64 (N,), positions (N,3), rotations (N,4) xyzw) from the HMD
    pose CSV.  Rows with the wrong field count are skipped, and so are rows
    with any missing or non-finite value."""
    pos_cols = ("pos_x", "pos_y", "pos_z")
    rot_cols = ("rot_x", "rot_y", "rot_z", "rot_w")
    times, positions, rotations = [], [], []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header is None:
            return (np.zeros(0, np.int64), np.zeros((0, 3)), np.zeros((0, 4)))
        col = {name.strip(): i for i, name in enumerate(header)}
        for row in reader:
            if len(row) != len(header):
                continue
            if any(cell.strip() in _NA_TEXT for cell in row):
                continue
            try:
                values = [parse_float(row[col[c]]) for c in ("unix_time",) + pos_cols + rot_cols]
            except ValueError:
                continue
            if any(math.isnan(v) for v in values):
                continue
            times.append(int(values[0]))
            positions.append(values[1:4])
            rotations.append(values[4:8])
    return (np.asarray(times, np.int64),
            np.asarray(positions, np.float64).reshape(-1, 3),
            np.asarray(rotations, np.float64).reshape(-1, 4))
