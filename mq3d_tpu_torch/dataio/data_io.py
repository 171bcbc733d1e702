"""Single facade over all project data (reference: scripts/dataio/data_io.py:10-16)."""

from __future__ import annotations

from pathlib import Path

from mq3d_tpu_torch.config.paths import ProjectPathConfig
from mq3d_tpu_torch.dataio.depth_io import DepthDataIO
from mq3d_tpu_torch.dataio.image_io import ImageDataIO
from mq3d_tpu_torch.dataio.recon_io import ReconstructionDataIO
from mq3d_tpu_torch.dataio.rgbd_io import RGBDDataIO


class DataIO:
    def __init__(self, project_dir: Path):
        self.path_config = ProjectPathConfig(project_dir=project_dir)
        self.color = ImageDataIO(image_path_config=self.path_config.image)
        self.depth = DepthDataIO(depth_path_config=self.path_config.depth)
        self.rgbd = RGBDDataIO(
            image_data_io=self.color,
            depth_data_io=self.depth,
            rgbd_path_config=self.path_config.rgbd,
        )
        self.reconstruction = ReconstructionDataIO(
            reconstruction_path_config=self.path_config.reconstruction
        )
