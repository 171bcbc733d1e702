"""Fragment generation: intra-fragment pose graphs from depth odometry.

Counterpart of mq3d_tpu/recon/fragments.py (reference make_fragments.py:
14-308): each side's depth sequence is split into fragments of
`fragment_size` frames; within a fragment, sequential odometry edges plus
keyframe loop closures, gated by a frustum AABB overlap test and a yaw
information density threshold, feed a Levenberg-Marquardt pose graph.
A fragment's depth stack goes to the device once, and the information
matrices of all its edges come from one call.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from mq3d_tpu_torch.config.configs import FragmentGenerationConfig
from mq3d_tpu_torch.dataio.depth_io import DepthDataIO
from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.models.datasets import DepthDataset
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops.odometry import odometry_information_matrix_batch
from mq3d_tpu_torch.ops.posegraph import (
    GlobalOptimizationOption,
    PoseGraphEdge,
    global_optimization,
)
from mq3d_tpu_torch.recon.graph_utils import (
    convert_pose_graph_to_transforms,
    convert_transforms_to_pose_graph,
)
from mq3d_tpu_torch.recon.integrate import load_filtered_depth_stack
from mq3d_tpu_torch.utils.log import substep


def frustum_overlap_filter(extrinsic_cw_1: np.ndarray, extrinsic_cw_2: np.ndarray,
                           intrinsic_1: np.ndarray, intrinsic_2: np.ndarray,
                           image_size_1, image_size_2, z_near: float = 0.1,
                           z_far: float = 3.0, overlap_ratio_threshold: float = 0.05) -> bool:
    """Frustum AABB-overlap gate for loop-closure candidates
    (reference make_fragments.py:14-81)."""

    def frustum_points(cw, K, size):
        fx, fy = K[0, 0], K[1, 1]
        cx, cy = K[0, 2], K[1, 2]
        w, h = size
        uv = np.array([(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1), (w // 2, h // 2)])
        rays = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv))], -1)
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
        return np.concatenate([rays * d @ cw[:3, :3].T + cw[:3, 3] for d in (z_near, z_far)])

    p1 = frustum_points(extrinsic_cw_1, intrinsic_1, image_size_1)
    p2 = frustum_points(extrinsic_cw_2, intrinsic_2, image_size_2)
    min1, max1 = p1.min(0), p1.max(0)
    min2, max2 = p2.min(0), p2.max(0)
    inter = np.prod(np.maximum(np.minimum(max1, max2) - np.maximum(min1, min2), 0.0))
    if inter == 0.0:
        return False
    v1 = np.prod(np.maximum(max1 - min1, 0.0))
    v2 = np.prod(np.maximum(max2 - min2, 0.0))
    return inter / min(v1, v2) > overlap_ratio_threshold


def build_pose_graph_for_fragment(frag_dataset: DepthDataset, depth_stack: np.ndarray,
                                  frame_valid: np.ndarray, config: FragmentGenerationConfig,
                                  device="cuda"):
    """Odometry chain + gated keyframe loop closures (reference
    make_fragments.py:84-242).  The depth stack must be confidence-filtered
    and the transforms in the OPEN3D camera frame.  The edges are not
    padded: the JAX package pads them to a power of two only so that one
    compiled program serves fragments of similar size."""
    n = len(frag_dataset)
    intrinsic = frag_dataset.get_render_intrinsic_matrices().astype(np.float32)[0]
    transforms = frag_dataset.transforms
    extrinsics_wc = transforms.extrinsics_wc.astype(np.float64)
    extrinsics_cw = transforms.extrinsics_cw.astype(np.float64)

    pose_graph = convert_transforms_to_pose_graph(transforms)

    odo_pairs = [(i, i + 1) for i in range(n - 1) if frame_valid[i] and frame_valid[i + 1]]

    key_indices = list(range(0, n, max(config.odometry_loop_interval, 1)))
    loop_pairs = []
    for a_pos, key_i in enumerate(key_indices):
        if not frame_valid[key_i]:
            continue
        # Reference quirk kept: the image size is indexed by the keyframe's
        # position in the keyframe list (make_fragments.py:171-172).
        width = int(frag_dataset.widths[a_pos]) if a_pos < n else int(frag_dataset.widths[0])
        height = int(frag_dataset.heights[a_pos]) if a_pos < n else int(frag_dataset.heights[0])
        for key_j in key_indices[a_pos + 1:]:
            if not frame_valid[key_j]:
                continue
            if frustum_overlap_filter(
                    extrinsics_cw[key_i], extrinsics_cw[key_j], intrinsic, intrinsic,
                    (width, height), (width, height), z_near=0.1, z_far=config.depth_max,
                    overlap_ratio_threshold=config.overlap_ratio_threshold):
                loop_pairs.append((key_i, key_j, width, height))

    all_pairs = odo_pairs + [(i, j) for i, j, _, _ in loop_pairs]
    if not all_pairs:
        return pose_graph

    pairs = np.asarray(all_pairs, np.int64)
    rel = extrinsics_wc[pairs[:, 1]] @ extrinsics_cw[pairs[:, 0]]  # float64
    infos, _ = odometry_information_matrix_batch(
        torch.from_numpy(depth_stack).to(device), torch.from_numpy(intrinsic).to(device),
        pairs, torch.from_numpy(rel.astype(np.float32)).to(device),
        dist_threshold=float(config.dist_threshold), depth_max=float(config.depth_max))

    for e, (i, j) in enumerate(odo_pairs):
        pose_graph.edges.append(PoseGraphEdge(
            source_node_id=i, target_node_id=j, transformation=rel[e],
            information=infos[e], uncertain=False))
    for k, (key_i, key_j, width, height) in enumerate(loop_pairs):
        e = len(odo_pairs) + k
        if infos[e][5, 5] / (width * height) > config.loop_yaw_info_density_threshold:
            pose_graph.edges.append(PoseGraphEdge(
                source_node_id=key_i, target_node_id=key_j, transformation=rel[e],
                information=infos[e], uncertain=True))
    print(f"[Info] Fragment pose graph: {len(odo_pairs)} odometry edges, "
          f"{len(loop_pairs)} loop candidates, "
          f"{len(pose_graph.edges) - len(odo_pairs)} loops kept")
    return pose_graph


def optimize_dataset_pose(frag_dataset: DepthDataset, depth_stack: np.ndarray,
                          frame_valid: np.ndarray, config: FragmentGenerationConfig,
                          device="cuda") -> None:
    """Build and optimize one fragment's pose graph, writing the refined
    transforms back into the dataset (reference make_fragments.py:245-271)."""
    with substep("fragment_odometry"):
        pose_graph = build_pose_graph_for_fragment(frag_dataset, depth_stack, frame_valid,
                                                   config, device=device)
    option = GlobalOptimizationOption(
        max_correspondence_distance=config.dist_threshold,
        edge_prune_threshold=config.edge_prune_threshold, reference_node=0)
    with substep("fragment_global_optimization"):
        global_optimization(pose_graph, option, device=device)
    frag_dataset.transforms = convert_pose_graph_to_transforms(pose_graph)


def make_fragment_datasets(depth_data_io: DepthDataIO, config: FragmentGenerationConfig,
                           device="cuda") -> Dict[Side, List[DepthDataset]]:
    """Split each side into fragments and optimize each fragment's poses
    on `device` (reference make_fragments.py:274-308)."""
    dev = resolve_device(device)
    fragment_dataset_map: Dict[Side, List[DepthDataset]] = {}
    for side in Side:
        depth_dataset = depth_data_io.load_depth_dataset(
            side=side, use_cache=config.use_dataset_cache)
        depth_dataset.transforms = depth_dataset.transforms.convert_coordinate_system(
            CoordinateSystem.OPEN3D, is_camera=True)
        frag_datasets = depth_dataset.split(fragment_size=config.fragment_size)
        fragment_dataset_map[side] = frag_datasets
        print(f"[{side.name}] Optimizing fragment poses: {len(frag_datasets)} fragments")
        offset = 0
        for frag in frag_datasets:
            indices = np.arange(offset, offset + len(frag))
            offset += len(frag)
            stack, valid = load_filtered_depth_stack(
                depth_data_io, side, depth_dataset, indices,
                config.use_confidence_filtered_depth, config.confidence_threshold,
                config.valid_count_threshold)
            optimize_dataset_pose(frag, stack, valid, config, device=dev)
    return fragment_dataset_map
