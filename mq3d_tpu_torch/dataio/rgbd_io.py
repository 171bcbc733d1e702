"""Color-aligned depth IO (reference: scripts/dataio/rgbd_data_io.py:8-32)."""

from __future__ import annotations

import numpy as np

from mq3d_tpu_torch.config.paths import RGBDPathConfig
from mq3d_tpu_torch.models.side import Side


class RGBDDataIO:
    def __init__(self, image_data_io, depth_data_io, rgbd_path_config: RGBDPathConfig):
        self.image_data_io = image_data_io
        self.depth_data_io = depth_data_io
        self.rgbd_path_config = rgbd_path_config

    def load_color_aligned_depth(self, side: Side, timestamp: int) -> np.ndarray:
        path = self.rgbd_path_config.get_color_aligned_depth_path(side, timestamp)
        if not path.exists():
            raise FileNotFoundError(f"Color-aligned depth file not found: {path}")
        return np.load(path)

    def save_color_aligned_depth(self, depth_map: np.ndarray, side: Side, timestamp: int):
        path = self.rgbd_path_config.get_color_aligned_depth_path(side, timestamp)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, depth_map)
