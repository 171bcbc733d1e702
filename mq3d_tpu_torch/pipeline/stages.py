"""Preprocessing stages: YUV->RGB and depth->linear directory conversion.

Counterpart of mq3d_tpu/pipeline/stages.py: frames stack into batches and
convert in one device launch (K2 on the card); blur/exposure filters run on
the batch.  A failed conversion raises: nothing here swallows a device or
kernel error.
"""

from __future__ import annotations

import shutil

import numpy as np
import torch

from mq3d_tpu_torch.config.configs import Depth2LinearConfig, Yuv2RgbConfig
from mq3d_tpu_torch.dataio.depth_io import DepthDataIO
from mq3d_tpu_torch.dataio.image_io import ImageDataIO
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.ops.depth import linear_depth_to_png_values
from mq3d_tpu_torch.ops.yuv import (
    bgr_to_gray,
    convert_yuv_batch,
    is_blur_image,
    is_over_or_under_exposed,
)

YUV_BATCH = 16


def convert_yuv_directory(image_io: ImageDataIO, config: Yuv2RgbConfig,
                          device="cuda"):
    """Both sides: batched YUV420_888 -> BGR -> PNG, with optional blur /
    exposure filtering; removes the raw YUV dir when every file was read."""
    for side in Side:
        timestamps = image_io.get_yuv_timestamps(side)
        if not timestamps:
            continue
        fmt = image_io.load_image_format_info(side)

        processed = excluded = failed = 0
        for s in range(0, len(timestamps), YUV_BATCH):
            raws, ok_ts = [], []
            for ts in timestamps[s:s + YUV_BATCH]:
                try:
                    raws.append(image_io.load_yuv(side, ts))
                    ok_ts.append(ts)
                except OSError as e:
                    print(f"[Exception] Failed to read {side}/{ts}: {e}")
                    failed += 1
            if not raws:
                continue
            bgrs = convert_yuv_batch(raws, fmt, device=device)

            keep = np.ones(len(ok_ts), bool)
            if config.blur_filter or config.exposure_filter:
                bgr_t = torch.from_numpy(bgrs)
            if config.blur_filter:
                keep &= ~is_blur_image(bgr_t, config.blur_threshold)
            if config.exposure_filter:
                keep &= ~is_over_or_under_exposed(
                    bgr_to_gray(bgr_t),
                    config.exposure_threshold_low,
                    config.exposure_threshold_high,
                )
            kept_idx = np.flatnonzero(keep)
            excluded += int(len(ok_ts) - len(kept_idx))
            if len(kept_idx):
                processed += image_io.save_bgr_batch(
                    bgrs[kept_idx], side, [ok_ts[i] for i in kept_idx])

        print(f"[Info] {processed} images written to "
              f"{image_io.image_path_config.get_rgb_dir(side)}")
        if excluded:
            print(f"[Info] {excluded} images were excluded by filtering.")
        if failed:
            print(f"[Error] {failed} files failed to read.")

        yuv_dir = image_io.image_path_config.get_yuv_dir(side)
        if failed == 0 and yuv_dir.exists():
            shutil.rmtree(yuv_dir)
            print(f"[Info] Cleaned up raw YUV directory: {yuv_dir}")
        elif failed > 0:
            print(f"[Warning] Keeping raw YUV directory for debugging: {yuv_dir}")


def convert_depth_directory(
    depth_data_io: DepthDataIO, depth_to_linear_config: Depth2LinearConfig
):
    """Both sides: NDC depth -> metric -> 8-bit grayscale PNGs (host numpy,
    as in the JAX build)."""
    for side in Side:
        dataset = depth_data_io.load_depth_dataset(
            side=side, use_cache=depth_to_linear_config.use_cache
        )
        for i in range(len(dataset)):
            depth_map = depth_data_io.load_depth_map_by_index(side, dataset, i)
            if depth_map is None:
                continue
            png_vals = linear_depth_to_png_values(
                depth_map,
                depth_to_linear_config.clip_near_m,
                depth_to_linear_config.clip_far_m,
            )
            depth_data_io.save_linear_depth_map(
                depth_map=png_vals, side=side, timestamp=int(dataset.timestamps[i])
            )
        print(f"[Info] Converted depth images for {side} camera to linear format.")
