"""Scene reconstruction orchestrator: steps 0 and 3 of the JAX build.

Counterpart of mq3d_tpu/recon/reconstruct.py:

  0. dataset generation (depth + color frame tables)
  3. TSDF integration of both sides into one volume, then
     reconstruction/colorless_vbg.npz and reconstruction/colorless.ply

Steps 1 (depth confidence), 2 (depth pose optimization), 4-5 (color
optimization, point sampling) and 6 (color-aligned depth rendering) are not
ported yet: switching one on raises NotImplementedError naming its
ROADMAP.md item, never a silent skip.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from mq3d_tpu_torch.config.configs import ReconstructionConfig
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.models.datasets import DepthDataset
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.recon.integrate import integrate_extract_small, integrate_multi
from mq3d_tpu_torch.utils.log import log_step, substep

# Viewer-time accounting: the reference prints "[VIS] <TAG>_VIEW_SECONDS: <t>"
# and its pipeline script subtracts that from the runtime.  This build is
# headless; it emits the same markers and keeps the total here.
LAST_VIEW_SECONDS = 0.0

_NOT_PORTED = {
    "estimate_depth_confidences": "queue A: confidence (B9)",
    "optimize_depth_pose": "queue A: the pose stack (B10-B11)",
    "optimize_color_pose": "queue A: color optimization (B12) and mesh filter (B13)",
    "render_color_aligned_depth": "queue A: raycast (B8)",
}


def _emit_view_seconds(tag: str, seconds: float) -> None:
    global LAST_VIEW_SECONDS
    LAST_VIEW_SECONDS += seconds
    print(f"[VIS] {tag}_VIEW_SECONDS: {seconds:.3f}")


def check_supported(config: ReconstructionConfig) -> None:
    """Raise NotImplementedError for a switched-on step this port lacks."""
    for flag, item in _NOT_PORTED.items():
        if getattr(config, flag):
            raise NotImplementedError(
                f"reconstruction.{flag} is on, but that step is not ported to "
                f"mq3d_tpu_torch yet (ROADMAP.md {item}); switch it off")


def load_depth_datasets(data_io: DataIO, config: ReconstructionConfig
                        ) -> Dict[Side, DepthDataset]:
    """Both sides' depth datasets with transforms in the OPEN3D camera frame
    (the dataset path the JAX build takes when pose optimization is off)."""
    out: Dict[Side, DepthDataset] = {}
    for side in Side:
        ds = data_io.depth.load_depth_dataset(
            side=side, use_cache=config.fragment_generation.use_dataset_cache)
        ds.transforms = ds.transforms.convert_coordinate_system(
            CoordinateSystem.OPEN3D, is_camera=True)
        out[side] = ds
    return out


def reconstruct_scene(data_io: DataIO, config: ReconstructionConfig,
                      device="cuda") -> Optional[TSDFVolume]:
    """Steps 0 and 3 on `device`; returns the volume (None if empty)."""
    global LAST_VIEW_SECONDS
    LAST_VIEW_SECONDS = 0.0
    check_supported(config)

    # Step 0: dataset generation
    if not config.use_dataset_cache:
        for side in Side:
            with substep(f"build_depth_dataset[{side.name}]"):
                data_io.depth.load_depth_dataset(side=side, use_cache=False)
            with substep(f"build_color_dataset[{side.name}]"):
                data_io.color.load_color_dataset(side=side, use_cache=False)

    depth_dataset_map = load_depth_datasets(data_io, config)

    # Step 3: TSDF integration
    vbg: Optional[TSDFVolume] = None
    if config.use_colorless_vbg_cache:
        vbg = data_io.reconstruction.load_colorless_vbg(device=device)

    fused_pcd = None
    if vbg is None:
        log_step("Integrate depth maps")
        ic = config.depth_integration
        with substep("integrate"):
            fused = integrate_extract_small(
                dataset_map=depth_dataset_map,
                depth_data_io=data_io.depth,
                config=ic,
                device=device,
            )
            if fused is not None:
                vbg, fused_pcd = fused
            else:
                vbg = integrate_multi(
                    dataset_map=depth_dataset_map,
                    depth_data_io=data_io.depth,
                    config=ic,
                    device=device,
                )

    if vbg is None or vbg.n_active == 0:
        print("[Error] Failed to generate TSDF volume; check inputs/config.")
        return None

    with substep("save_colorless_vbg"):
        save_colorless_vbg(data_io, vbg)
    with substep("extract_point_cloud"):
        colorless_pcd = fused_pcd if fused_pcd is not None else vbg.extract_point_cloud()
    with substep("save_colorless_pcd"):
        save_colorless_pcd(data_io, colorless_pcd)
    if config.visualize_colorless_pcd:
        t0 = time.perf_counter()
        print("[Info] Headless build: colorless point cloud saved to "
              f"{data_io.path_config.reconstruction.get_colorless_pcd_path()}")
        _emit_view_seconds("COLORLESS", time.perf_counter() - t0)
    return vbg


def save_colorless_vbg(data_io: DataIO, vbg: TSDFVolume) -> None:
    data_io.reconstruction.save_colorless_vbg(vbg)


def save_colorless_pcd(data_io: DataIO, pcd) -> None:
    data_io.reconstruction.save_colorless_pcd(pcd)
