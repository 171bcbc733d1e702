"""Pipeline orchestration with idempotent stage skipping.

Counterpart of mq3d_tpu/pipeline/processor.py: YUV->RGB fills only missing
frames; depth-linear skips when all PNGs exist unless force_recompute;
reconstruction caches are disabled under force_recompute.  Everything runs
on `device` ("cuda" unless the caller passes "cpu").
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from mq3d_tpu_torch.config.configs import PipelineConfigs
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.pipeline.stages import convert_depth_directory, convert_yuv_directory
from mq3d_tpu_torch.recon.reconstruct import reconstruct_scene
from mq3d_tpu_torch.utils.log import StageTimer


class PipelineProcessor:
    def __init__(
        self,
        project_dir: Path,
        config: Union[Path, str, PipelineConfigs],
        force_recompute: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.data_io = DataIO(project_dir=project_dir)
        self.pipeline_configs = (
            config if isinstance(config, PipelineConfigs)
            else PipelineConfigs.parse_config_yml(Path(config)))
        self.project_dir = project_dir
        self.force_recompute = force_recompute

    def convert_yuv_to_rgb(self):
        all_rgb_exist = True
        missing = 0
        total_yuv = 0
        for side in Side:
            yuv_ts = set(self.data_io.color.get_yuv_timestamps(side))
            total_yuv += len(yuv_ts)
            rgb_dir = self.data_io.color.image_path_config.get_rgb_dir(side)
            if not rgb_dir.exists():
                all_rgb_exist = False
                missing += len(yuv_ts)
                continue
            m = yuv_ts - set(self.data_io.color.get_rgb_timestamps(side))
            if m:
                all_rgb_exist = False
                missing += len(m)

        if all_rgb_exist and total_yuv > 0:
            print("[Info] All RGB images already exist. Skipping YUV to RGB conversion.")
            return
        if total_yuv == 0:
            print("[Info] No YUV images found. Skipping conversion.")
            return
        if missing:
            print(f"[Info] Found {missing} missing RGB images. Converting YUV to RGB...")
        convert_yuv_directory(
            image_io=self.data_io.color, config=self.pipeline_configs.yuv_to_rgb,
            device=self.device,
        )

    def convert_depth_to_linear(self):
        if not self.force_recompute:
            all_exist = True
            missing = 0
            total = 0
            for side in Side:
                ds = self.data_io.depth.load_depth_dataset(side=side, use_cache=True)
                depth_ts = set(int(t) for t in ds.timestamps.tolist())
                total += len(depth_ts)
                m = depth_ts - set(self.data_io.depth.get_linear_depth_timestamps(side))
                if m:
                    all_exist = False
                    missing += len(m)
            if all_exist and total > 0:
                print("[Info] All linear depth images exist. Skipping conversion.")
                return
            if total == 0:
                print("[Info] No depth frames found. Skipping conversion.")
                return
            if missing:
                print(f"[Info] Found {missing} missing linear depth images.")
        else:
            self.pipeline_configs.depth_to_linear.use_cache = False

        convert_depth_directory(
            depth_data_io=self.data_io.depth,
            depth_to_linear_config=self.pipeline_configs.depth_to_linear,
        )

    def reconstruct_scene(self):
        if self.force_recompute:
            rc = self.pipeline_configs.reconstruction
            rc.use_dataset_cache = False
            rc.use_fragment_dataset_cache = False
            rc.use_optimized_dataset_cache = False
            rc.use_colorless_vbg_cache = False
        return reconstruct_scene(
            data_io=self.data_io, config=self.pipeline_configs.reconstruction,
            device=self.device,
        )


@dataclass
class PipelineRun:
    stage_seconds: Dict[str, float]
    volume: Optional[TSDFVolume]  # None when reconstruction produced nothing


def run_full_pipeline(session_dir: Path, config: Union[Path, str, PipelineConfigs],
                      device="cuda", force_recompute: bool = False) -> PipelineRun:
    """YUV->RGB, depth->linear and reconstruction (steps 0-6, as the config
    switches them) of one capture session on `device`: writes the
    confidence maps and the optimized depth frame tables with steps 1-2 on,
    reconstruction/colorless_vbg.npz and colorless.ply and, with the colour
    steps on, the meshes, the colored point cloud, the optimised colour
    frame tables and the color-aligned depth maps.  Returns the seconds of
    each stage and the volume."""
    timer = StageTimer()
    processor = PipelineProcessor(
        project_dir=Path(session_dir), config=config,
        force_recompute=force_recompute, device=device,
    )
    sync = _device_sync(processor.device)
    print("\n[Step 1/3] Converting YUV to RGB...")
    with timer.stage("convert_yuv_to_rgb"):
        processor.convert_yuv_to_rgb()
        sync()
    print("\n[Step 2/3] Converting depth to linear...")
    with timer.stage("convert_depth_to_linear"):
        processor.convert_depth_to_linear()
    print("\n[Step 3/3] Reconstructing scene...")
    with timer.stage("reconstruct_scene"):
        volume = processor.reconstruct_scene()
        sync()
    return PipelineRun(stage_seconds=dict(timer.records), volume=volume)


def _device_sync(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
