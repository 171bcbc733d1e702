"""Session data wrangling: trimming, timestamp offsets, length analysis;
the counterpart of mq3d_tpu/analysis/sessions.py (host code, the same
semantics).

Re-design of the reference's analysis/processing tools (reference:
analysis/processing/trim_recordings.py, rename_timestamps.py,
find_optimal_timestamp_offset.py, analyze_recording_lengths.py,
analyze_duration_discrepancy.py): capture-session hygiene utilities that
keep all modalities (YUV/RGB frames, raw depth, HMD poses, descriptors)
consistent.  pandas is imported only inside the functions that read or
rewrite the CSVs (analyze_recording_lengths, trim_recording).
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mq3d_tpu_torch.config.paths import (
    CACHE_DIR_PATH,
    DEPTH_DESCRIPTOR_CSV_MAP,
    DEPTH_DIR_MAP,
    HMD_POSE_CSV_PATH,
    LINEAR_DEPTH_DIR_MAP,
    RGB_DIR_MAP,
    YUV_DIR_MAP,
)
from mq3d_tpu_torch.models.side import Side

_FRAME_DIR_MAPS = [YUV_DIR_MAP, RGB_DIR_MAP, DEPTH_DIR_MAP, LINEAR_DEPTH_DIR_MAP]


def _timestamped_files(directory: Path) -> List[Path]:
    if not directory.is_dir():
        return []
    return sorted(
        (p for p in directory.iterdir() if p.stem.isdigit()),
        key=lambda p: int(p.stem),
    )


@dataclass
class ModalityLength:
    name: str
    n_frames: int
    first_ts: Optional[int]
    last_ts: Optional[int]

    @property
    def duration_ms(self) -> Optional[int]:
        if self.first_ts is None or self.last_ts is None:
            return None
        return self.last_ts - self.first_ts


def analyze_recording_lengths(project_dir: Path) -> List[ModalityLength]:
    """Frame counts + time spans per modality (analyze_recording_lengths)."""
    project_dir = Path(project_dir)
    out = []
    for dmap in _FRAME_DIR_MAPS:
        for side in Side:
            files = _timestamped_files(project_dir / dmap[side])
            ts = [int(p.stem) for p in files]
            out.append(
                ModalityLength(
                    name=dmap[side],
                    n_frames=len(ts),
                    first_ts=min(ts) if ts else None,
                    last_ts=max(ts) if ts else None,
                )
            )
    pose_csv = project_dir / HMD_POSE_CSV_PATH
    if pose_csv.exists():
        import pandas as pd

        t = pd.read_csv(pose_csv, on_bad_lines="skip")["unix_time"].dropna()
        out.append(
            ModalityLength(
                "hmd_poses", len(t),
                int(t.min()) if len(t) else None,
                int(t.max()) if len(t) else None,
            )
        )
    return out


def analyze_duration_discrepancy(project_dir: Path) -> Dict[str, float]:
    """Max pairwise duration discrepancy between modalities (ms)."""
    lengths = [m for m in analyze_recording_lengths(project_dir) if m.duration_ms]
    if not lengths:
        return {"max_discrepancy_ms": 0.0}
    durations = {m.name: m.duration_ms for m in lengths}
    vals = list(durations.values())
    return {
        "max_discrepancy_ms": float(max(vals) - min(vals)),
        **{f"duration_ms/{k}": float(v) for k, v in durations.items()},
    }


def trim_recording(
    project_dir: Path,
    max_duration_ms: Optional[int] = None,
    max_frames: Optional[int] = None,
    dry_run: bool = False,
) -> Dict[str, int]:
    """Trim all frame modalities consistently to a duration/frame budget and
    clear stale caches (reference trim_recordings.py semantics).

    Trimming keeps the earliest frames; the HMD pose CSV and depth
    descriptor CSVs are filtered to the retained time range.
    """
    project_dir = Path(project_dir)
    removed: Dict[str, int] = {}

    # Establish the cutoff from the depth modality (the pipeline's clock).
    ref_files = _timestamped_files(project_dir / DEPTH_DIR_MAP[Side.LEFT])
    if not ref_files:
        ref_files = _timestamped_files(project_dir / RGB_DIR_MAP[Side.LEFT]) or \
            _timestamped_files(project_dir / YUV_DIR_MAP[Side.LEFT])
    if not ref_files:
        return removed
    ts = [int(p.stem) for p in ref_files]
    cutoff = ts[-1]
    if max_frames is not None and len(ts) > max_frames:
        cutoff = ts[max_frames - 1]
    if max_duration_ms is not None:
        cutoff = min(cutoff, ts[0] + max_duration_ms)

    for dmap in _FRAME_DIR_MAPS:
        for side in Side:
            d = project_dir / dmap[side]
            n = 0
            for p in _timestamped_files(d):
                if int(p.stem) > cutoff:
                    n += 1
                    if not dry_run:
                        p.unlink()
            if n:
                removed[dmap[side]] = n

    # Filter CSVs.
    if not dry_run:
        import pandas as pd

        pose_csv = project_dir / HMD_POSE_CSV_PATH
        if pose_csv.exists():
            df = pd.read_csv(pose_csv, on_bad_lines="skip")
            df = df[df["unix_time"] <= cutoff]
            df.to_csv(pose_csv, index=False)
        for side in Side:
            desc = project_dir / DEPTH_DESCRIPTOR_CSV_MAP[side]
            if desc.exists():
                df = pd.read_csv(desc)
                df = df[df["timestamp_ms"] <= cutoff]
                df.to_csv(desc, index=False)

        # Stale caches must be rebuilt after trimming.
        for cache in ["dataset", CACHE_DIR_PATH, "reconstruction"]:
            d = project_dir / cache
            if d.is_dir():
                shutil.rmtree(d)
    return removed


def rename_timestamps(
    project_dir: Path, offset_ms: int, modalities: Optional[List[str]] = None,
    dry_run: bool = False,
) -> int:
    """Apply a millisecond offset to frame filenames
    (reference rename_timestamps.py)."""
    project_dir = Path(project_dir)
    count = 0
    for dmap in _FRAME_DIR_MAPS:
        for side in Side:
            name = dmap[side]
            if modalities is not None and name not in modalities:
                continue
            d = project_dir / name
            files = _timestamped_files(d)
            # Rename in an order that avoids collisions.
            ordered = files if offset_ms < 0 else list(reversed(files))
            for p in ordered:
                new = d / f"{int(p.stem) + offset_ms}{p.suffix}"
                count += 1
                if not dry_run:
                    p.rename(new)
    return count


def find_optimal_timestamp_offset(
    project_dir: Path,
    source: str = "left_depth",
    target: str = "left_camera_rgb",
    offsets_ms: Optional[np.ndarray] = None,
    tolerance_ms: int = 17,
) -> Dict[str, float]:
    """Scan candidate offsets maximizing frame-timestamp overlap between two
    modalities (reference find_optimal_timestamp_offset.py)."""
    project_dir = Path(project_dir)
    src = np.asarray([int(p.stem) for p in _timestamped_files(project_dir / source)])
    tgt = np.asarray([int(p.stem) for p in _timestamped_files(project_dir / target)])
    if offsets_ms is None:
        offsets_ms = np.arange(-500, 501, 5)
    if len(src) == 0 or len(tgt) == 0:
        return {"best_offset_ms": 0.0, "best_overlap": 0.0}

    tgt_sorted = np.sort(tgt)
    best_off, best_overlap = 0, -1.0
    for off in offsets_ms:
        shifted = src + off
        idx = np.searchsorted(tgt_sorted, shifted)
        prev = np.abs(shifted - tgt_sorted[np.clip(idx - 1, 0, len(tgt) - 1)])
        nxt = np.abs(tgt_sorted[np.clip(idx, 0, len(tgt) - 1)] - shifted)
        matched = (np.minimum(prev, nxt) <= tolerance_ms).mean()
        if matched > best_overlap:
            best_overlap = float(matched)
            best_off = int(off)
    return {"best_offset_ms": float(best_off), "best_overlap": best_overlap}
