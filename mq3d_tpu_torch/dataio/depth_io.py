"""Depth frame IO: raw NDC float32 buffers, descriptors, confidence maps.

Re-design of the reference's DepthDataIO (reference:
scripts/dataio/depth_data_io.py:14-281).  Same artifact formats, plus
batched stack loaders (`load_depth_stack`) that stage whole frame ranges as
one (N, H, W) array for device launches instead of per-frame Python loops.
Descriptor CSVs are parsed without pandas (dataio/csv_io.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mq3d_tpu_torch.config.paths import DepthPathConfig
from mq3d_tpu_torch.dataio.csv_io import parse_float, read_rows
from mq3d_tpu_torch.geometry.intrinsics import depth_camera_params
from mq3d_tpu_torch.models.camera import ConfidenceMap
from mq3d_tpu_torch.models.datasets import DepthDataset
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem, Transforms
from mq3d_tpu_torch.ops.depth import convert_depth_to_linear, is_depth_map_valid
from mq3d_tpu_torch.utils.png import imwrite


class DepthDataIO:
    def __init__(self, depth_path_config: DepthPathConfig):
        self.depth_path_config = depth_path_config
        self.depth_descriptors: Dict[Side, List[Dict[str, str]]] = {}
        self.depth_datasets: Dict[Side, DepthDataset] = {}
        # Confidence maps are consumed by several stages (fragments,
        # refinement, integration) for the same frames; cache decoded maps.
        self._confidence_cache: Dict[tuple, Optional[ConfidenceMap]] = {}
        # Open mmap handles of the packed confidence stacks, per side.
        self._confidence_pack: Dict[Side, tuple] = {}

    # -- descriptors -------------------------------------------------------------

    def load_depth_descriptors(self, side: Side) -> List[Dict[str, str]]:
        """Descriptor CSV rows as dicts of column -> text, in file order."""
        if side in self.depth_descriptors:
            return self.depth_descriptors[side]
        rows = read_rows(self.depth_path_config.get_depth_descriptor_path(side))
        self.depth_descriptors[side] = rows
        return rows

    # -- raw depth ------------------------------------------------------------------

    def load_depth_map(
        self, side: Side, timestamp: int, width: int, height: int, near: float, far: float
    ) -> Optional[np.ndarray]:
        """Load one raw NDC frame and linearize (reference depth_data_io.py:33-53)."""
        path = self.depth_path_config.get_depth_map_path(side, timestamp)
        if not path.exists():
            return None
        depth_array = np.fromfile(path, dtype="<f4").reshape((height, width))
        if not is_depth_map_valid(depth_array):
            return None
        return np.asarray(convert_depth_to_linear(depth_array, near, far))

    def load_depth_map_by_index(
        self, side: Side, dataset: DepthDataset, index: int
    ) -> Optional[np.ndarray]:
        if index < 0 or index >= len(dataset):
            return None
        return self.load_depth_map(
            side=side,
            timestamp=int(dataset.timestamps[index]),
            width=int(dataset.widths[index]),
            height=int(dataset.heights[index]),
            near=float(dataset.nears[index]),
            far=float(dataset.fars[index]),
        )

    def load_depth_stack(
        self, side: Side, dataset: DepthDataset, indices: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched loader: (N, H, W) float32 linear-depth stack + validity mask.

        Raw files are read with numpy.fromfile, then validated and
        NDC-linearized as stacked array ops.  Invalid/missing
        frames become all-zero maps with valid=False; zero depth is already
        "no data" downstream.  Requires uniform frame size within the
        requested range (true for QRC captures).
        """
        if indices is None:
            indices = np.arange(len(dataset))
        indices = np.asarray(indices, np.int64)
        n = len(indices)
        if n == 0:
            return np.zeros((0, 0, 0), np.float32), np.zeros(0, bool)
        h = int(dataset.heights[indices[0]])
        w = int(dataset.widths[indices[0]])

        uniform = bool(
            (dataset.heights[indices] == h).all() and (dataset.widths[indices] == w).all()
        )
        if not uniform:
            # Rare mixed-size fallback: per-frame loads.
            stack = np.zeros((n, h, w), dtype=np.float32)
            valid = np.zeros(n, dtype=bool)
            for out_i, i in enumerate(indices):
                d = self.load_depth_map_by_index(side, dataset, int(i))
                if d is not None and d.shape == (h, w):
                    stack[out_i] = d
                    valid[out_i] = True
            return stack, valid

        paths = [
            self.depth_path_config.get_depth_map_path(side, int(dataset.timestamps[i]))
            for i in indices
        ]
        raw = np.zeros((n, h, w), "<f4")
        ok = np.zeros(n, bool)
        for i, p in enumerate(paths):
            if not p.exists():
                continue
            buf = np.fromfile(p, dtype="<f4")
            if buf.size == h * w:
                raw[i] = buf.reshape(h, w)
                ok[i] = True

        # Vectorized sensor-dropout validity (depth_data_io.py:80-85).
        any_nonzero = (raw != 0).any(axis=(1, 2))
        any_nonone = (raw != 1).any(axis=(1, 2))
        no_nan = ~np.isnan(raw).any(axis=(1, 2))
        non_negative = np.nanmin(np.where(np.isnan(raw), 0, raw), axis=(1, 2)) >= 0
        valid = ok & any_nonzero & any_nonone & no_nan & non_negative

        nears = dataset.nears[indices].astype(np.float64)
        fars = dataset.fars[indices].astype(np.float64)
        stack = np.asarray(convert_depth_to_linear(raw.astype(np.float64), nears, fars))
        stack[~valid] = 0.0
        return stack.astype(np.float32), valid

    # -- confidence maps ---------------------------------------------------------------

    def exists_depth_confidence_map_dir(self, side: Side) -> bool:
        return self.depth_path_config.get_depth_confidence_map_dir_path(side).exists()

    def load_confidence_map(self, side: Side, timestamp: int) -> Optional[ConfidenceMap]:
        key = (side, int(timestamp))
        if key in self._confidence_cache:
            return self._confidence_cache[key]
        path = self.depth_path_config.get_depth_confidence_map_path(side, timestamp)
        out = None
        if path.exists():
            try:
                data = np.load(path)
                out = ConfidenceMap(
                    confidence_map=data["confidence_map"], valid_count=data["valid_count"]
                )
            except Exception as e:
                print(f"[Error] Failed to load confidence map {side.name}@{timestamp}: {e}")
        if out is not None:
            self._confidence_cache[key] = out
        return out

    def save_confidence_map(self, side: Side, timestamp: int, confidence_map: ConfidenceMap):
        path = self.depth_path_config.get_depth_confidence_map_path(side, timestamp)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path,
            confidence_map=confidence_map.confidence_map,
            valid_count=confidence_map.valid_count,
        )
        self._confidence_cache[(side, int(timestamp))] = confidence_map
        # A new/changed per-frame map makes the packed stack stale.
        self.invalidate_confidence_pack(side)

    # -- packed confidence stack ------------------------------------------------------
    #
    # The integrate hot path consumes confidence maps for every frame of every
    # chunk (recon/integrate.py); opening one npz per frame per chunk is real
    # host time at 1000 frames on a small host.  The pack stores all of a
    # side's maps as three .npy files (timestamps, confidence, valid_count)
    # that load as O(1) memory maps; chunk requests then slice rows.

    _PACK_MEMBERS = ("timestamps", "confidence", "valid_count")

    def _confidence_pack_paths(self, side: Side):
        pc = self.depth_path_config
        return [pc.get_confidence_pack_path(side, m) for m in self._PACK_MEMBERS]

    def invalidate_confidence_pack(self, side: Side) -> None:
        self._confidence_pack.pop(side, None)
        for p in self._confidence_pack_paths(side):
            try:
                p.unlink()
            except FileNotFoundError:
                pass

    def _open_confidence_pack(self, side: Side):
        """(timestamps, conf_mmap, cnt_mmap) or None."""
        cached = self._confidence_pack.get(side)
        if cached is not None:
            return cached
        ts_path, conf_path, cnt_path = self._confidence_pack_paths(side)
        if not (ts_path.exists() and conf_path.exists() and cnt_path.exists()):
            return None
        try:
            ts = np.load(ts_path)
            conf = np.load(conf_path, mmap_mode="r")
            cnt = np.load(cnt_path, mmap_mode="r")
            # Shape-skipped frames leave trailing spare rows in the stacks.
            if len(ts) > len(conf) or len(ts) > len(cnt):
                return None
            conf = conf[: len(ts)]
            cnt = cnt[: len(ts)]
        except Exception as e:
            print(f"[Warning] Corrupt confidence pack for {side.name}: {e}")
            return None
        self._confidence_pack[side] = (ts, conf, cnt)
        return self._confidence_pack[side]

    def load_confidence_stack(
        self, side: Side, timestamps: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched confidence read: (conf (N,H,W), valid_count (N,H,W),
        have (N,) bool) for the requested timestamps; rows with have=False
        are zero.  Rows come from the packed cache where confidence
        estimation wrote one, and from the per-frame npz maps otherwise."""
        timestamps = np.asarray(timestamps, np.int64)
        n = len(timestamps)
        pack = self._open_confidence_pack(side)
        conf = cnt = None
        have = np.zeros(n, bool)
        if pack is not None:
            ts, conf_mm, cnt_mm = pack
            pos = np.minimum(np.searchsorted(ts, timestamps), len(ts) - 1)
            have = ts[pos] == timestamps
            conf = np.zeros((n,) + conf_mm.shape[1:], conf_mm.dtype)
            cnt = np.zeros((n,) + cnt_mm.shape[1:], cnt_mm.dtype)
            if have.any():
                conf[have] = conf_mm[pos[have]]
                cnt[have] = cnt_mm[pos[have]]
        # Rows absent from the pack (no pack, written after the pack, or a
        # stray resolution mismatch skipped at build) fill from the
        # per-frame npzs — never a from-disk pack rebuild here, which costs
        # more than per-frame loads ever do.
        for i in np.nonzero(~have)[0]:
            cm = self.load_confidence_map(side, int(timestamps[i]))
            if cm is None:
                continue
            if conf is None:
                conf = np.zeros(
                    (n,) + cm.confidence_map.shape, cm.confidence_map.dtype)
                cnt = np.zeros(
                    (n,) + cm.valid_count.shape, cm.valid_count.dtype)
            if cm.confidence_map.shape != conf.shape[1:]:
                continue  # caller warns on the surviving have=False row
            conf[i] = cm.confidence_map
            cnt[i] = cm.valid_count
            have[i] = True
        if conf is None:
            return (
                np.zeros((n, 0, 0), np.float32),
                np.zeros((n, 0, 0), np.float32),
                have,
            )
        return conf, cnt, have

    # -- datasets ------------------------------------------------------------------------

    def load_depth_dataset(self, side: Side, use_cache: bool = True) -> DepthDataset:
        if side in self.depth_datasets:
            return self.depth_datasets[side]

        cache_path = self.depth_path_config.get_depth_dataset_path(side)
        if use_cache and cache_path.exists():
            print(f"[Info] Loading cached depth dataset for {side.name} ...")
            try:
                ds = DepthDataset.load(cache_path)
                self.depth_datasets[side] = ds
                return ds
            except Exception as e:
                print(f"[Error] Depth dataset cache corrupt; rebuilding. {e}")
        else:
            print(f"[Info] Building depth dataset for {side.name} ...")

        ds = self.build_depth_dataset(side)
        self.depth_datasets[side] = ds
        ds.save(cache_path)
        return ds

    def load_optimized_depth_dataset(self, side: Side) -> Optional[DepthDataset]:
        path = self.depth_path_config.get_optimized_depth_dataset_path(side)
        if path.exists():
            try:
                return DepthDataset.load(path)
            except Exception as e:
                print(f"[Error] Optimized depth dataset cache corrupt. {e}")
        print("[Info] Optimized depth dataset not found. Will rebuild it.")
        return None

    def save_optimized_depth_dataset(self, side: Side, dataset: DepthDataset):
        dataset.save(self.depth_path_config.get_optimized_depth_dataset_path(side))

    def build_depth_dataset(self, side: Side) -> DepthDataset:
        """Frame table from descriptor CSV, dropping frames whose raw file is
        missing or fails the sensor-dropout check
        (reference depth_data_io.py:166-261)."""
        rows = self.load_depth_descriptors(side)

        directory_path = self.depth_path_config.get_depth_dir(side)
        directory_relative_path = self.depth_path_config.get_relative_path(directory_path)

        cols: Dict[str, List] = {k: [] for k in (
            "filename", "timestamp", "fx", "fy", "cx", "cy", "position",
            "rotation", "width", "height", "near", "far",
        )}

        for row in rows:
            timestamp = int(parse_float(row["timestamp_ms"]))
            width, height = int(parse_float(row["width"])), int(parse_float(row["height"]))
            near, far = parse_float(row["near_z"]), parse_float(row["far_z"])

            fx, fy, cx, cy = depth_camera_params(
                parse_float(row["fov_left_angle_tangent"]),
                parse_float(row["fov_right_angle_tangent"]),
                parse_float(row["fov_top_angle_tangent"]),
                parse_float(row["fov_down_angle_tangent"]),
                width,
                height,
            )

            depth_map = self.load_depth_map(side, timestamp, width, height, near, far)
            if depth_map is None:
                continue

            cols["filename"].append(self.depth_path_config.get_depth_map_filename(timestamp))
            cols["timestamp"].append(timestamp)
            cols["fx"].append(fx)
            cols["fy"].append(fy)
            cols["cx"].append(cx)
            cols["cy"].append(cy)
            cols["position"].append(
                [parse_float(row[f"create_pose_location_{a}"]) for a in "xyz"]
            )
            cols["rotation"].append(
                [parse_float(row[f"create_pose_rotation_{a}"]) for a in "xyzw"]
            )
            cols["width"].append(width)
            cols["height"].append(height)
            cols["near"].append(near)
            cols["far"].append(far)

        return DepthDataset(
            directory_relative_path=str(directory_relative_path),
            image_file_names=np.asarray(cols["filename"]),
            timestamps=np.asarray(cols["timestamp"]),
            fx=np.asarray(cols["fx"]),
            fy=np.asarray(cols["fy"]),
            cx=np.asarray(cols["cx"]),
            cy=np.asarray(cols["cy"]),
            transforms=Transforms(
                coordinate_system=CoordinateSystem.UNITY,
                positions=np.asarray(cols["position"], dtype=np.float64),
                rotations=np.asarray(cols["rotation"], dtype=np.float64),
            ),
            widths=np.asarray(cols["width"]),
            heights=np.asarray(cols["height"]),
            nears=np.asarray(cols["near"]),
            fars=np.asarray(cols["far"]),
        )

    # -- linear depth PNGs -------------------------------------------------------------------

    def save_linear_depth_map(self, depth_map: np.ndarray, side: Side, timestamp: int):
        d = self.depth_path_config.get_linear_depth_dir(side)
        d.mkdir(parents=True, exist_ok=True)
        imwrite(d / f"{timestamp}.png", depth_map)

    def get_linear_depth_timestamps(self, side: Side) -> List[int]:
        d = self.depth_path_config.get_linear_depth_dir(side)
        if not d.exists():
            return []
        return sorted(int(p.stem) for p in d.glob("*.png") if p.stem.isdigit())
