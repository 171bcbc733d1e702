"""Reconstruction artifact persistence: fragments, TSDF volume, meshes, pcds.

Mirrors the reference's ReconstructionDataIO surface (reference:
scripts/dataio/reconstruction_data_io.py:9-145) using our own PLY/PCD codecs
and the mq3d TSDF voxel-grid npz schema shared with the JAX build
(see ops/tsdf.py):
  reconstruction/colorless_vbg.npz: block_coords (N,3) i32,
  tsdf (N, R^3) f32, weight (N, R^3) f32, voxel_size, block_resolution,
  grid_dim scalars.
"""

from __future__ import annotations

import zipfile
from typing import Dict, List, Optional

from mq3d_tpu_torch.config.paths import ReconstructionPathConfig
from mq3d_tpu_torch.dataio.ply import (
    PointCloud,
    TriangleMesh,
    read_pcd,
    read_ply,
    write_pcd,
    write_ply_mesh,
    write_ply_pointcloud,
)
from mq3d_tpu_torch.models.datasets import DepthDataset
from mq3d_tpu_torch.models.side import Side


class ReconstructionDataIO:
    def __init__(self, reconstruction_path_config: ReconstructionPathConfig):
        self.reconstruction_path_config = reconstruction_path_config

    # -- fragment caches ---------------------------------------------------------

    def load_fragment_datasets(self) -> Dict[Side, List[DepthDataset]]:
        path_map = self.reconstruction_path_config.get_fragment_dataset_paths()
        return {
            side: [DepthDataset.load(p) for p in paths]
            for side, paths in path_map.items()
        }

    def save_fragment_dataset(self, dataset: DepthDataset, side: Side, index: int):
        path = self.reconstruction_path_config.get_fragment_dataset_path(side, index)
        dataset.save(path)

    def load_fragment_pcd(self, side: Side, index: int) -> PointCloud:
        return read_pcd(self.reconstruction_path_config.get_fragment_pcd_path(side, index))

    def save_fragment_pcd(self, pcd: PointCloud, side: Side, index: int):
        write_pcd(self.reconstruction_path_config.get_fragment_pcd_path(side, index), pcd)

    # -- TSDF volume --------------------------------------------------------------

    def load_colorless_vbg(self, device="cuda"):
        """The cached volume on `device`, or None when there is no cache or
        the cache file is unreadable (then the caller rebuilds it)."""
        path = self.reconstruction_path_config.get_colorless_vbg_path()
        if not path.exists():
            return None
        from mq3d_tpu_torch.ops.tsdf import TSDFVolume

        try:
            return TSDFVolume.load(path, device=device)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            print(f"[Error] TSDF volume cache corrupt: {e}")
            return None

    def save_colorless_vbg(self, vbg):
        path = self.reconstruction_path_config.get_colorless_vbg_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        vbg.save(path)

    # -- point clouds / meshes -------------------------------------------------------

    def save_colorless_pcd(self, pcd: PointCloud):
        write_ply_pointcloud(self.reconstruction_path_config.get_colorless_pcd_path(), pcd)

    def load_colorless_pcd(self) -> Optional[PointCloud]:
        p = self.reconstruction_path_config.get_colorless_pcd_path()
        return read_ply(p) if p.exists() else None

    def save_colorless_mesh_raw(self, mesh: TriangleMesh):
        write_ply_mesh(self.reconstruction_path_config.get_colorless_mesh_raw_path(), mesh)

    def save_colorless_mesh_clean(self, mesh: TriangleMesh):
        write_ply_mesh(self.reconstruction_path_config.get_colorless_mesh_clean_path(), mesh)

    def save_colored_mesh(self, mesh: TriangleMesh):
        write_ply_mesh(self.reconstruction_path_config.get_colored_mesh_path(), mesh)

    def load_colored_mesh(self) -> Optional[TriangleMesh]:
        p = self.reconstruction_path_config.get_colored_mesh_path()
        return read_ply(p) if p.exists() else None

    def save_colored_pcd(self, pcd: PointCloud):
        write_ply_pointcloud(self.reconstruction_path_config.get_colored_pcd_path(), pcd)

    def load_colored_pcd(self) -> Optional[PointCloud]:
        p = self.reconstruction_path_config.get_colored_pcd_path()
        return read_ply(p) if p.exists() else None
