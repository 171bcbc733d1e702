"""Scene reconstruction orchestrator: steps 0-6 of the JAX build.

Counterpart of mq3d_tpu/recon/reconstruct.py:

  0. dataset generation (depth + color frame tables)
  1. depth confidence estimation (batched reprojection)
  2. depth pose optimization (fragments + scene pose graph)
  3. TSDF integration of both sides into one volume, then
     reconstruction/colorless_vbg.npz and reconstruction/colorless.ply
  4. color map optimization: marching cubes, the component filter, the
     photometric pose refinement and vertex-color baking
  5. point sampling from the colored mesh
  6. color-aligned depth rendering (TSDF raycast)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from mq3d_tpu_torch.config.configs import ReconstructionConfig
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.models.datasets import CameraDataset, DepthDataset
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops.mesh_filter import filter_mesh_components
from mq3d_tpu_torch.ops.raycast import raycast_in_color_view
from mq3d_tpu_torch.ops.sampling import sample_points_uniformly
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.recon.color_opt import optimize_color_pose
from mq3d_tpu_torch.recon.confidence import estimate_depth_confidences
from mq3d_tpu_torch.recon.depth_pose_optimizer import DepthPoseOptimizer
from mq3d_tpu_torch.recon.integrate import integrate_extract_small, integrate_multi
from mq3d_tpu_torch.utils.log import log_step, substep

# Viewer-time accounting: the reference prints "[VIS] <TAG>_VIEW_SECONDS: <t>"
# and its pipeline script subtracts that from the runtime.  This build is
# headless; it emits the same markers and keeps the total here.
LAST_VIEW_SECONDS = 0.0


def _emit_view_seconds(tag: str, seconds: float) -> None:
    global LAST_VIEW_SECONDS
    LAST_VIEW_SECONDS += seconds
    print(f"[VIS] {tag}_VIEW_SECONDS: {seconds:.3f}")


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
    """Steps 0-6, as the config switches them, on `device`; returns the
    volume (None if empty)."""
    global LAST_VIEW_SECONDS
    LAST_VIEW_SECONDS = 0.0

    # Step 0: dataset generation
    if not config.use_dataset_cache:
        for side in Side:
            with substep(f"build_depth_dataset[{side.name}]"):
                data_io.depth.load_depth_dataset(side=side, use_cache=False)
            with substep(f"build_color_dataset[{side.name}]"):
                data_io.color.load_color_dataset(side=side, use_cache=False)

    # Step 1: depth confidence estimation
    if config.estimate_depth_confidences:
        log_step("Estimate depth confidences")
        with substep("estimate_depth_confidences"):
            estimate_depth_confidences(depth_data_io=data_io.depth,
                                       config=config.confidence_estimation, device=device)

    # Step 2: depth pose optimization
    if config.optimize_depth_pose:
        optimizer = DepthPoseOptimizer(depth_data_io=data_io.depth,
                                       recon_data_io=data_io.reconstruction,
                                       config=config, device=device)
        with substep("depth_pose_optimizer"):
            depth_dataset_map = optimizer()
    else:
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

    # Step 4: color map optimization
    optimized_color_dataset_map: Optional[Dict[Side, CameraDataset]] = None
    if config.optimize_color_pose:
        co = config.color_optimization
        log_step("Extract and save colorless mesh")
        with substep("extract_triangle_mesh"):
            colorless_mesh = vbg.extract_triangle_mesh(
                weight_threshold=co.weight_threshold,
                estimated_vertex_number=co.estimated_vertex_number)
        with substep("save_colorless_mesh_raw"):
            data_io.reconstruction.save_colorless_mesh_raw(colorless_mesh)
        with substep("filter_mesh_components"):
            filtered_mesh = filter_mesh_components(
                colorless_mesh, min_triangle_count=co.min_triangle_count, device=vbg.device)
        colorless_mesh = filtered_mesh
        if config.visualize_colorless_pcd and len(colorless_mesh.vertices):
            # Height-colored debug coloring (the reference shows it in a
            # viewer; the headless build keeps it in the cleaned mesh).
            z = colorless_mesh.vertices[:, 2]
            z_min, z_max = float(z.min()), float(z.max())
            zn = (z - z_min) / ((z_max - z_min) if z_max > z_min else 1.0)
            colorless_mesh = dataclasses.replace(colorless_mesh, vertex_colors=np.clip(
                np.stack([zn, 1.0 - np.abs(zn - 0.5) * 2.0, 1.0 - zn], axis=-1), 0.0, 1.0))
        with substep("save_colorless_mesh_clean"):
            data_io.reconstruction.save_colorless_mesh_clean(colorless_mesh)

        log_step("Optimize color maps")
        with substep("optimize_color_pose"):
            colored_mesh, optimized_color_dataset_map = optimize_color_pose(
                vbg=vbg, data_io=data_io, config=co, mesh=filtered_mesh)
        with substep("save_colored_mesh"):
            data_io.reconstruction.save_colored_mesh(colored_mesh)
        if config.visualize_colored_mesh:
            t0 = time.perf_counter()
            print("[Info] Headless build: colored mesh saved to "
                  f"{data_io.path_config.reconstruction.get_colored_mesh_path()}")
            _emit_view_seconds("COLORED", time.perf_counter() - t0)
        with substep("save_optimized_color_datasets"):
            for side, ds in optimized_color_dataset_map.items():
                data_io.color.save_optimized_color_dataset(dataset=ds, side=side)

        # Step 5: point sampling
        if config.sample_point_cloud_from_colored_mesh:
            with substep("sample_colored_pcd"):
                n_points = int(len(colored_mesh.vertices) * config.points_per_vertex_ratio)
                pcd = sample_points_uniformly(colored_mesh, n_points)
                data_io.reconstruction.save_colored_pcd(pcd)

    # Step 6: color-aligned depth rendering
    if config.render_color_aligned_depth:
        log_step("Render color-aligned depth")
        with substep("render_color_aligned_depth"):
            render_color_aligned_depth(data_io, config, vbg, optimized_color_dataset_map)
    return vbg


def render_color_aligned_depth(data_io: DataIO, config: ReconstructionConfig,
                               vbg: TSDFVolume,
                               optimized: Optional[Dict[Side, CameraDataset]]) -> None:
    """Step 6: z-depth in each color view, rendered from the volume and
    written as reconstruction's color-aligned depth .npy files: the
    optimized keyframes, plus the other frames unless
    only_use_optimized_dataset."""
    rc = config.color_aligned_depth_rendering

    def render(dataset: CameraDataset, side: Side, desc: str):
        print(f"{desc}: {len(dataset)} frames")
        it = raycast_in_color_view(volume=vbg, dataset=dataset,
                                   frames_per_batch=rc.frames_per_batch,
                                   transfer_u16=bool(rc.transfer_u16))
        for ts in dataset.timestamps:
            data_io.rgbd.save_color_aligned_depth(depth_map=next(it), side=side,
                                                  timestamp=int(ts))

    def to_open3d(ds: CameraDataset) -> CameraDataset:
        ds.transforms = ds.transforms.convert_coordinate_system(
            CoordinateSystem.OPEN3D, is_camera=True)
        return ds

    for side in Side:
        color_dataset = data_io.color.load_color_dataset(side=side, use_cache=True)
        if optimized is not None:
            if not rc.only_use_optimized_dataset:
                opt_ts = set(int(t) for t in optimized[side].timestamps)
                rest = color_dataset[[i for i in range(len(color_dataset))
                                      if int(color_dataset.timestamps[i]) not in opt_ts]]
                render(to_open3d(rest), side, f"[{side.name}] Rendering color-aligned depth")
            render(optimized[side], side, f"[{side.name}] Rendering optimized-view depth")
        elif not rc.only_use_optimized_dataset:
            render(to_open3d(color_dataset), side,
                   f"[{side.name}] Rendering color-aligned depth")


def save_colorless_vbg(data_io: DataIO, vbg: TSDFVolume) -> None:
    data_io.reconstruction.save_colorless_vbg(vbg)


def save_colorless_pcd(data_io: DataIO, pcd) -> None:
    data_io.reconstruction.save_colorless_pcd(pcd)
