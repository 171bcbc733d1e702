"""Color image + camera metadata IO.

Re-design of the reference's ImageDataIO (reference:
scripts/dataio/image_data_io.py:16-297) with the pose interpolation done as
one vectorized batch instead of per-frame dataframe scans.

Convention fixups preserved exactly (reference image_data_io.py:147-168):
Android camera pose -> HMD frame requires a z-flip on translation, conjugated
(qx, qy) on the quaternion, inversion, and a 180-degree x-rotation.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from mq3d_tpu_torch.config.paths import ImagePathConfig
from mq3d_tpu_torch.dataio.pose_interpolator import PoseInterpolator
from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.models.camera import (
    BaseTime,
    CameraCharacteristics,
    ImageFormatInfo,
    ImagePlaneInfo,
)
from mq3d_tpu_torch.models.datasets import CameraDataset
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem, Transforms
from mq3d_tpu_torch.utils.png import imread_bgr, imwrite


class ImageDataIO:
    def __init__(self, image_path_config: ImagePathConfig):
        self.image_path_config = image_path_config

    # -- timestamp discovery ---------------------------------------------------

    @staticmethod
    def _parse_timestamp_stem(stem: str, filename: str, prefix: str) -> Optional[int]:
        """Handles macOS sidecar prefixes (reference image_data_io.py:21-34)."""
        if stem.startswith("._"):
            stem = stem[2:]
        elif stem.startswith("_"):
            stem = stem.lstrip("_")
        if stem == "" or not stem.isdigit():
            print(f"[Warning] Skipping non-timestamped {prefix} file: {filename}")
            return None
        return int(stem)

    def get_yuv_timestamps(self, side: Side) -> List[int]:
        out = []
        for p in self.image_path_config.get_yuv_image_paths(side):
            ts = self._parse_timestamp_stem(p.stem, p.name, "YUV")
            if ts is not None:
                out.append(ts)
        return out

    def get_rgb_timestamps(self, side: Side) -> List[int]:
        out = []
        for p in self.image_path_config.get_rgb_image_paths(side):
            ts = self._parse_timestamp_stem(p.stem, p.name, "RGB")
            if ts is not None:
                out.append(ts)
        return out

    # -- pixel IO ----------------------------------------------------------------

    def load_yuv(self, side: Side, timestamp: int) -> np.ndarray:
        file_path = self.image_path_config.get_yuv_dir(side) / f"{timestamp}.yuv"
        return np.fromfile(file_path, dtype=np.uint8)

    def load_rgb(self, side: Side, timestamp: int) -> np.ndarray:
        file_path = self.image_path_config.get_rgb_file_path(side, timestamp)
        bgr = imread_bgr(file_path)
        if bgr is None:
            raise FileNotFoundError(f"Image file not found or unreadable: {file_path}")
        return bgr[..., ::-1].copy()  # BGR -> RGB

    def save_rgb(self, rgb: np.ndarray, side: Side, timestamp: int):
        self.save_bgr(rgb[..., ::-1], side, timestamp)

    def save_bgr(self, bgr: np.ndarray, side: Side, timestamp: int):
        file_path = self.image_path_config.get_rgb_file_path(side, timestamp)
        file_path.parent.mkdir(parents=True, exist_ok=True)
        imwrite(file_path, np.ascontiguousarray(bgr))

    def save_bgr_batch(self, bgrs: np.ndarray, side: Side,
                       timestamps) -> int:
        """PNG-encode a (N, H, W, 3) BGR batch on a thread pool (the YUV
        stage's write path; zlib releases the interpreter lock).  Returns
        the number written."""
        paths = [self.image_path_config.get_rgb_file_path(side, int(ts))
                 for ts in timestamps]
        if not paths:
            return 0
        paths[0].parent.mkdir(parents=True, exist_ok=True)
        workers = min(len(paths), os.cpu_count() or 1, 8)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [pool.submit(imwrite, p, np.ascontiguousarray(b))
                       for p, b in zip(paths, bgrs)]
            for fut in futures:
                fut.result()
        return len(paths)

    # -- metadata -----------------------------------------------------------------

    def load_image_format_info(self, side: Side) -> ImageFormatInfo:
        with open(self.image_path_config.get_camera_format_json_path(side)) as f:
            d = json.load(f)
        planes = [
            ImagePlaneInfo(
                buffer_size=p["bufferSize"],
                row_stride=p["rowStride"],
                pixel_stride=p["pixelStride"],
            )
            for p in d["planes"]
        ]
        bt = d["baseTime"]
        return ImageFormatInfo(
            width=d["width"],
            height=d["height"],
            format=d["format"],
            planes=planes,
            base_time=BaseTime(bt["baseMonoTimeNs"], bt["baseUnixTimeMs"]),
        )

    def load_camera_characteristics(self, side: Side) -> CameraCharacteristics:
        path = self.image_path_config.get_camera_characteristic_json_path(side)
        if not path.exists():
            # Fall back to the opposite side (reference image_data_io.py:121-131).
            other = Side.LEFT if side == Side.RIGHT else Side.RIGHT
            fallback = self.image_path_config.get_camera_characteristic_json_path(other)
            if fallback.exists():
                print(
                    f"[Warning] Camera characteristics for {side.name} missing; "
                    f"using {other.name} as fallback."
                )
                path = fallback
            else:
                raise FileNotFoundError(
                    f"Camera characteristics not found for {side.name} ({path}) "
                    f"nor fallback ({fallback})"
                )

        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)

        arr = d["sensor"]["activeArraySize"]
        width = arr["right"] - arr["left"]
        height = arr["bottom"] - arr["top"]
        intr = d["intrinsics"]

        pose = d["pose"]
        transl = np.asarray(pose["translation"], dtype=np.float64)
        if transl.shape[0] < 3:
            transl = np.zeros(3)
        else:
            transl = transl.copy()
            transl[2] *= -1  # Android -> HMD z-flip

        rot_raw = pose["rotation"]
        if len(rot_raw) >= 4:
            # Conjugate x/y, invert, then rotate 180 deg about x
            # (reference image_data_io.py:154-165).
            q = np.asarray(
                [-rot_raw[0], -rot_raw[1], rot_raw[2], rot_raw[3]], dtype=np.float64
            )
            q = np.asarray(quat.conjugate(q))  # inverse of unit quaternion
            x180 = np.asarray([1.0, 0.0, 0.0, 0.0])  # 180 deg about x, xyzw
            rot_quat = np.asarray(quat.multiply(q, x180))
        else:
            rot_quat = np.asarray([0.0, 0.0, 0.0, 1.0])

        return CameraCharacteristics(
            width=width,
            height=height,
            fx=intr["fx"],
            fy=intr["fy"],
            cx=intr["cx"],
            cy=intr["cy"],
            transl=transl,
            rot_quat=rot_quat,
        )

    # -- dataset construction ------------------------------------------------------

    def load_color_dataset(self, side: Side, use_cache: bool = True) -> CameraDataset:
        cache_path = self.image_path_config.get_color_dataset_path(side)
        if use_cache and cache_path.exists():
            print(f"[Info] Loading cached color dataset for {side.name} ...")
            try:
                return CameraDataset.load(cache_path)
            except Exception as e:
                print(f"[Error] Color dataset cache corrupt; rebuilding. {e}")
        else:
            print(f"[Info] Building color dataset for {side.name} ...")
        ds = self.build_color_dataset(side)
        ds.save(cache_path)
        return ds

    def load_optimized_color_dataset(self, side: Side) -> Optional[CameraDataset]:
        path = self.image_path_config.get_optimized_color_dataset_path(side)
        if path.exists():
            try:
                return CameraDataset.load(path)
            except Exception:
                print("[Error] Optimized color dataset cache corrupt.")
        return None

    def save_optimized_color_dataset(self, dataset: CameraDataset, side: Side):
        path = self.image_path_config.get_optimized_color_dataset_path(side)
        dataset.save(path)

    def build_color_dataset(self, side: Side) -> CameraDataset:
        """RGB frame table with per-frame camera poses interpolated from the
        HMD pose track in one vectorized pass
        (reference image_data_io.py:228-297)."""
        interpolator = PoseInterpolator(self.image_path_config.get_hmd_pose_csv_path())
        cam = self.load_camera_characteristics(side)

        directory_path = self.image_path_config.get_rgb_dir(side)
        directory_relative_path = self.image_path_config.get_relative_path(directory_path)

        filenames, timestamps = [], []
        for p in self.image_path_config.get_rgb_image_paths(side):
            ts = self._parse_timestamp_stem(p.stem, p.name, "RGB")
            if ts is not None:
                filenames.append(p.name)
                timestamps.append(ts)

        if not timestamps:
            raise RuntimeError(
                f"[Error] No RGB images for {side.name}; run YUV->RGB conversion first."
            )

        ts_arr = np.asarray(timestamps, dtype=np.int64)
        positions, rotations, valid = interpolator.interpolate_poses(ts_arr)
        if not valid.all():
            for t in ts_arr[~valid]:
                print(f"[Warning] No pose found for timestamp {t}. Skipping this image.")
        filenames = [f for f, v in zip(filenames, valid) if v]
        ts_arr = ts_arr[valid]
        positions = positions[valid]
        rotations = rotations[valid]

        if len(ts_arr) == 0:
            raise RuntimeError(
                f"[Error] No valid timestamps: cannot build color dataset for {side.name}."
            )

        hmd = Transforms(CoordinateSystem.UNITY, positions, rotations)
        camera_transforms = hmd.apply_local_transform(cam.transl, cam.rot_quat)

        n = len(ts_arr)
        return CameraDataset(
            directory_relative_path=str(directory_relative_path),
            image_file_names=np.asarray(filenames),
            timestamps=ts_arr,
            fx=np.full(n, cam.fx, dtype=np.int64 if isinstance(cam.fx, int) else np.float64),
            fy=np.full(n, cam.fy),
            cx=np.full(n, cam.cx),
            cy=np.full(n, cam.cy),
            transforms=camera_transforms,
            widths=np.full(n, cam.width, dtype=np.int64),
            heights=np.full(n, cam.height, dtype=np.int64),
        )
