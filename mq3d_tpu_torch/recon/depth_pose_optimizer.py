"""Cache-or-compute driver of the two-level depth pose optimization,
reconstruction step 2 (counterpart of mq3d_tpu/recon/depth_pose_optimizer.py;
reference depth_pose_optimizer.py:14-101)."""

from __future__ import annotations

from typing import Dict, List

from mq3d_tpu_torch.config.configs import ReconstructionConfig
from mq3d_tpu_torch.dataio.depth_io import DepthDataIO
from mq3d_tpu_torch.dataio.recon_io import ReconstructionDataIO
from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.models.datasets import DepthDataset
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.recon.fragments import make_fragment_datasets
from mq3d_tpu_torch.recon.refine import refine_fragment_poses
from mq3d_tpu_torch.utils.log import log_step, substep


def merge_fragment_datasets(
        frag_dataset_map: Dict[Side, List[DepthDataset]]) -> Dict[Side, DepthDataset]:
    return {side: DepthDataset.merge(frags) for side, frags in frag_dataset_map.items()}


class DepthPoseOptimizer:
    """Step 2 on `device`: fragment poses (cached in the reconstruction
    directory), then the scene refinement; returns both sides' optimized
    depth datasets, also saved, in the OPEN3D camera frame."""

    def __init__(self, depth_data_io: DepthDataIO, recon_data_io: ReconstructionDataIO,
                 config: ReconstructionConfig, device="cuda"):
        self.depth_data_io = depth_data_io
        self.recon_data_io = recon_data_io
        self.config = config
        self.device = resolve_device(device)

    def __call__(self) -> Dict[Side, DepthDataset]:
        return self.load_or_optimize_dataset()

    def load_or_make_fragment_datasets(self) -> Dict[Side, List[DepthDataset]]:
        if self.config.use_fragment_dataset_cache:
            frag_map = self.recon_data_io.load_fragment_datasets()
            if frag_map and any(len(v) > 0 for v in frag_map.values()):
                print("[Info] Fragment datasets loaded from cache.")
                for datasets in frag_map.values():
                    for ds in datasets:
                        if ds.transforms.coordinate_system != CoordinateSystem.OPEN3D:
                            ds.transforms = ds.transforms.convert_coordinate_system(
                                CoordinateSystem.OPEN3D)
                return frag_map

        log_step("Make Fragments")
        with substep("make_fragments"):
            frag_map = make_fragment_datasets(
                depth_data_io=self.depth_data_io, config=self.config.fragment_generation,
                device=self.device)
        print("[Info] Saving fragment datasets to cache...")
        for side, frags in frag_map.items():
            for i, frag in enumerate(frags):
                self.recon_data_io.save_fragment_dataset(frag, side, i)
        return frag_map

    def load_or_optimize_dataset(self) -> Dict[Side, DepthDataset]:
        if self.config.use_optimized_dataset_cache:
            cached: Dict[Side, DepthDataset] = {}
            for side in Side:
                ds = self.depth_data_io.load_optimized_depth_dataset(side)
                if ds is not None:
                    cached[side] = ds
            if cached:
                print("[Info] Optimized depth datasets loaded.")
                return cached

        frag_map = self.load_or_make_fragment_datasets()

        log_step("Refine Fragment poses")
        refine_fragment_poses(
            depth_data_io=self.depth_data_io, recon_data_io=self.recon_data_io,
            fragment_dataset_map=frag_map, config=self.config.fragment_pose_refinement,
            device=self.device)

        with substep("save_optimized_depth_datasets"):
            optimized = merge_fragment_datasets(frag_map)
            for side, ds in optimized.items():
                self.depth_data_io.save_optimized_depth_dataset(side=side, dataset=ds)
        print("[Info] Optimized depth datasets saved.")
        return optimized
