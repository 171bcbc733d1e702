"""Project directory layout — the on-disk "database" of a capture session.

The layout is kept byte-identical to the reference
(reference: scripts/config/project_path_config.py:6-261) so that a project
directory produced by either implementation is consumable by the other:

  left_camera_raw/ right_camera_raw/          raw YUV frames  <ts>.yuv
  left_camera_rgb/ right_camera_rgb/          converted RGB   <ts>.png
  left_depth/ right_depth/                    raw float32 NDC depth <ts>.raw
  left_depth_linear/ right_depth_linear/      8-bit linear depth PNGs
  left_depth_confidence/ ...                  per-frame confidence npz
  dataset/*.npz                               frame-table caches
  cache/{dataset,pcd}/                        fragment caches
  reconstruction/*.{npz,ply}                  TSDF + meshes + point clouds
  left_color_aligned_depth/ ...               rendered depth npys
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

from mq3d_tpu_torch.models.side import Side

YUV_DIR_MAP = {Side.LEFT: "left_camera_raw", Side.RIGHT: "right_camera_raw"}
RGB_DIR_MAP = {Side.LEFT: "left_camera_rgb", Side.RIGHT: "right_camera_rgb"}

CAMERA_CHARACTERISTICS_JSON_MAP = {
    Side.LEFT: "left_camera_characteristics.json",
    Side.RIGHT: "right_camera_characteristics.json",
}
CAMERA_FORMAT_INFO_JSON_MAP = {
    Side.LEFT: "left_camera_image_format.json",
    Side.RIGHT: "right_camera_image_format.json",
}

HMD_POSE_CSV_PATH = "hmd_poses.csv"

COLOR_DATASET_NPZ_MAP = {
    Side.LEFT: "dataset/left_camera_dataset.npz",
    Side.RIGHT: "dataset/right_camera_dataset.npz",
}
OPTIMIZED_COLOR_DATASET_NPZ_MAP = {
    Side.LEFT: "dataset/left_camera_dataset_optimized.npz",
    Side.RIGHT: "dataset/right_camera_dataset_optimized.npz",
}

DEPTH_DIR_MAP = {Side.LEFT: "left_depth", Side.RIGHT: "right_depth"}
DEPTH_DESCRIPTOR_CSV_MAP = {
    Side.LEFT: "left_depth_descriptors.csv",
    Side.RIGHT: "right_depth_descriptors.csv",
}
DEPTH_CONFIDENCE_MAP_DIR_MAP = {
    Side.LEFT: "left_depth_confidence",
    Side.RIGHT: "right_depth_confidence",
}
LINEAR_DEPTH_DIR_MAP = {Side.LEFT: "left_depth_linear", Side.RIGHT: "right_depth_linear"}
DEPTH_DATASET_NPZ_MAP = {
    Side.LEFT: "dataset/left_depth_dataset.npz",
    Side.RIGHT: "dataset/right_depth_dataset.npz",
}
OPTIMIZED_DEPTH_DATASET_NPZ_MAP = {
    Side.LEFT: "dataset/left_depth_dataset_optimized.npz",
    Side.RIGHT: "dataset/right_depth_dataset_optimized.npz",
}

COLOR_ALIGNED_DEPTH_DIR_MAP = {
    Side.LEFT: "left_color_aligned_depth",
    Side.RIGHT: "right_color_aligned_depth",
}

CACHE_DIR_PATH = "cache"
FRAGMENT_DATASET_CACHE_DIR_PATH = f"{CACHE_DIR_PATH}/dataset"
FRAGMENT_PCD_CACHE_DIR_PATH = f"{CACHE_DIR_PATH}/pcd"
# Cache of the JAX build, read here too (not a reference artifact): packed, mmap-able stack of
# the per-frame confidence npz maps, so the integrate hot path slices chunks
# out of two .npy files instead of opening one zip per frame per chunk.
CONFIDENCE_PACK_CACHE_DIR_PATH = f"{CACHE_DIR_PATH}/confidence"


class ImagePathConfig:
    def __init__(self, project_dir: Path):
        self.project_dir = project_dir

    def get_yuv_dir(self, side: Side) -> Path:
        return self.project_dir / YUV_DIR_MAP[side]

    def get_yuv_image_paths(self, side: Side) -> List[Path]:
        return sorted(self.get_yuv_dir(side).glob("*.yuv"))

    def get_rgb_dir(self, side: Side) -> Path:
        return self.project_dir / RGB_DIR_MAP[side]

    def get_rgb_file_path(self, side: Side, timestamp: int) -> Path:
        return self.get_rgb_dir(side) / f"{timestamp}.png"

    def get_rgb_image_paths(self, side: Side) -> List[Path]:
        return sorted(self.get_rgb_dir(side).glob("*.png"))

    def get_camera_characteristic_json_path(self, side: Side) -> Path:
        return self.project_dir / CAMERA_CHARACTERISTICS_JSON_MAP[side]

    def get_camera_format_json_path(self, side: Side) -> Path:
        return self.project_dir / CAMERA_FORMAT_INFO_JSON_MAP[side]

    def get_hmd_pose_csv_path(self) -> Path:
        return self.project_dir / HMD_POSE_CSV_PATH

    def get_color_dataset_path(self, side: Side) -> Path:
        return self.project_dir / COLOR_DATASET_NPZ_MAP[side]

    def get_optimized_color_dataset_path(self, side: Side) -> Path:
        return self.project_dir / OPTIMIZED_COLOR_DATASET_NPZ_MAP[side]

    def get_relative_path(self, path: Path) -> Path:
        return path.relative_to(self.project_dir)


class DepthPathConfig:
    def __init__(self, project_dir: Path):
        self.project_dir = project_dir

    def get_depth_dir(self, side: Side) -> Path:
        return self.project_dir / DEPTH_DIR_MAP[side]

    def get_depth_map_paths(self, side: Side) -> List[Path]:
        return sorted(self.get_depth_dir(side).glob("*.raw"))

    def get_depth_map_filename(self, timestamp: int) -> str:
        return f"{timestamp}.raw"

    def get_depth_map_path(self, side: Side, timestamp: int) -> Path:
        return self.get_depth_dir(side) / self.get_depth_map_filename(timestamp)

    def get_depth_descriptor_path(self, side: Side) -> Path:
        return self.project_dir / DEPTH_DESCRIPTOR_CSV_MAP[side]

    def get_depth_confidence_map_dir_path(self, side: Side) -> Path:
        return self.project_dir / DEPTH_CONFIDENCE_MAP_DIR_MAP[side]

    def get_depth_confidence_map_path(self, side: Side, timestamp: int) -> Path:
        return self.get_depth_confidence_map_dir_path(side) / f"{timestamp}.npz"

    def get_confidence_pack_path(self, side: Side, member: str) -> Path:
        """Packed confidence cache member ('timestamps' | 'confidence' |
        'valid_count') as an mmap-able .npy (see CONFIDENCE_PACK_CACHE_DIR_PATH)."""
        return (
            self.project_dir
            / CONFIDENCE_PACK_CACHE_DIR_PATH
            / f"{side.name.lower()}_{member}.npy"
        )

    def get_depth_dataset_path(self, side: Side) -> Path:
        return self.project_dir / DEPTH_DATASET_NPZ_MAP[side]

    def get_optimized_depth_dataset_path(self, side: Side) -> Path:
        return self.project_dir / OPTIMIZED_DEPTH_DATASET_NPZ_MAP[side]

    def get_linear_depth_dir(self, side: Side) -> Path:
        return self.project_dir / LINEAR_DEPTH_DIR_MAP[side]

    def get_relative_path(self, path: Path) -> Path:
        return path.relative_to(self.project_dir)


class RGBDPathConfig:
    def __init__(self, project_dir: Path):
        self.project_dir = project_dir

    def get_color_aligned_depth_filename(self, timestamp: int) -> str:
        return f"{timestamp}.npy"

    def get_color_aligned_depth_dir(self, side: Side) -> Path:
        return self.project_dir / COLOR_ALIGNED_DEPTH_DIR_MAP[side]

    def get_color_aligned_depth_path(self, side: Side, timestamp: int) -> Path:
        return self.get_color_aligned_depth_dir(side) / self.get_color_aligned_depth_filename(
            timestamp
        )


class ReconstructionPathConfig:
    def __init__(self, project_dir: Path):
        self.project_dir = project_dir

    def get_fragment_dir(self) -> Path:
        return self.project_dir / FRAGMENT_DATASET_CACHE_DIR_PATH

    def get_fragment_dataset_paths(self) -> Dict[Side, List[Path]]:
        dir_path = self.get_fragment_dir()
        if not dir_path.is_dir():
            return {}
        return {
            side: sorted(dir_path.glob(f"{side.name}_fragment_*_dataset.npz"))
            for side in Side
        }

    def get_fragment_dataset_path(self, side: Side, index: int) -> Path:
        return self.get_fragment_dir() / f"{side.name}_fragment_{index}_dataset.npz"

    def get_fragment_pcd_path(self, side: Side, index: int) -> Path:
        return (
            self.project_dir
            / FRAGMENT_PCD_CACHE_DIR_PATH
            / f"{side.name}_fragment_{index}.pcd"
        )

    def get_colorless_vbg_path(self) -> Path:
        return self.project_dir / "reconstruction/colorless_vbg.npz"

    def get_colorless_pcd_path(self) -> Path:
        return self.project_dir / "reconstruction/colorless.ply"

    def get_colorless_mesh_raw_path(self) -> Path:
        return self.project_dir / "reconstruction/colorless_mesh_raw.ply"

    def get_colorless_mesh_clean_path(self) -> Path:
        return self.project_dir / "reconstruction/colorless_mesh_clean.ply"

    def get_colored_mesh_path(self) -> Path:
        return self.project_dir / "reconstruction/color_mesh.ply"

    def get_colored_pcd_path(self) -> Path:
        return self.project_dir / "reconstruction/color.ply"

    def get_relative_path(self, path: Path) -> Path:
        return path.relative_to(self.project_dir)


class ProjectPathConfig:
    def __init__(self, project_dir: Path):
        self.project_dir = Path(project_dir).resolve()
        self.image = ImagePathConfig(self.project_dir)
        self.depth = DepthPathConfig(self.project_dir)
        self.rgbd = RGBDPathConfig(self.project_dir)
        self.reconstruction = ReconstructionPathConfig(self.project_dir)
