"""Inter-fragment pose refinement: fragment TSDF point clouds, pairwise ICP
and the scene pose graph.

Counterpart of mq3d_tpu/recon/refine.py (reference
refine_fragment_poses.py:14-321): each fragment is integrated into its own
TSDF volume (Phase B through K5 on the card) and extracted to a
point cloud; consecutive fragments of a side give odometry edges and every
pair gives a loop edge, gated by a down-sampled pre-filter; each edge's
transform comes from multi-scale point-to-point ICP with a G^T G
information matrix; the optimized fragment poses apply as world
transforms to every frame of the fragment.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from mq3d_tpu_torch.config.configs import FragmentPoseRefinementConfig
from mq3d_tpu_torch.dataio.depth_io import DepthDataIO
from mq3d_tpu_torch.dataio.ply import PointCloud
from mq3d_tpu_torch.dataio.recon_io import ReconstructionDataIO
from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.models.datasets import DepthDataset
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.ops.icp import (
    ICPConvergenceCriteria,
    build_grid_nn,
    build_voronoi_nn,
    evaluate_registration,
    get_information_matrix,
    get_information_matrix_batch,
    registration_icp,
    registration_icp_batch_shared,
    uniform_down_sample,
    voxel_down_sample,
)
from mq3d_tpu_torch.ops.posegraph import (
    GlobalOptimizationOption,
    PoseGraph,
    PoseGraphEdge,
    global_optimization,
)
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.recon.graph_utils import convert_pose_graph_to_transforms
from mq3d_tpu_torch.recon.integrate import integrate, tsdf_config_from_integration
from mq3d_tpu_torch.utils.log import substep


def integrate_fragment_point_cloud(depth_data_io: DepthDataIO, frag_dataset: DepthDataset,
                                   side: Side, config: FragmentPoseRefinementConfig,
                                   vol_opt: Optional[TSDFVolume] = None,
                                   device="cuda") -> Optional[PointCloud]:
    """One fragment -> TSDF -> surface point cloud (reference
    refine_fragment_poses.py:14-58), or None when the cloud is empty.  A
    volume passed as vol_opt is reset and reused.  Every other failure
    propagates: the JAX package prints it and drops the fragment, which on
    the card would hide a device fault."""
    vol = integrate(dataset=frag_dataset, depth_data_io=depth_data_io, side=side,
                    config=config,
                    vbg_opt=(vol_opt.reset() if vol_opt is not None else
                             TSDFVolume(tsdf_config_from_integration(config), device=device)),
                    device=device)
    pcd = vol.extract_point_cloud(weight_threshold=3.0)
    if len(pcd) == 0:
        print(f"[Warning] Fragment point cloud for {side.name} is empty.")
        return None
    return pcd


def integrate_and_save_fragment_point_clouds(
        depth_data_io: DepthDataIO, recon_data_io: ReconstructionDataIO,
        fragment_dataset_map: Dict[Side, List[DepthDataset]],
        config: FragmentPoseRefinementConfig, device="cuda") -> Dict[Side, int]:
    """Every fragment's point cloud, in order, through one reused volume
    (reference refine_fragment_poses.py:61-119); returns the number of
    non-empty fragments per side."""
    counts: Dict[Side, int] = {}
    total, empty = 0, 0
    shared_vol = TSDFVolume(tsdf_config_from_integration(config), device=device)
    for side, frag_datasets in fragment_dataset_map.items():
        print(f"[{side.name}] Integrating fragments: {len(frag_datasets)}")
        index = 0
        for frag in frag_datasets:
            pcd = integrate_fragment_point_cloud(depth_data_io, frag, side, config,
                                                 vol_opt=shared_vol, device=device)
            total += 1
            if pcd is None:
                empty += 1
                continue
            recon_data_io.save_fragment_pcd(pcd, side, index)
            index += 1
        counts[side] = index
    if empty:
        print(f"[Warning] {empty}/{total} fragment point clouds were empty.")
    if all(c == 0 for c in counts.values()):
        raise RuntimeError("All fragments produced empty point clouds.")
    return counts


class _FragmentCache:
    """Per-fragment registration assets, loaded or built once for the
    O(F^2) pairs: raw points, the ICP voxel pyramid, and the target grids
    per pyramid level, kept on the device."""

    def __init__(self, recon_data_io: ReconstructionDataIO,
                 config: FragmentPoseRefinementConfig, device="cuda"):
        self.io = recon_data_io
        self.config = config
        self.device = resolve_device(device)
        self.points: dict = {}
        self.pyramids: dict = {}
        self.grids: dict = {}

    def get_points(self, key: Tuple[Side, int]) -> np.ndarray:
        if key not in self.points:
            self.points[key] = self.io.load_fragment_pcd(*key).points
        return self.points[key]

    def get_pyramid(self, key) -> List[np.ndarray]:
        if key not in self.pyramids:
            pts = self.get_points(key)
            self.pyramids[key] = [voxel_down_sample(pts, v) for v in self.config.icp_voxel_sizes]
        return self.pyramids[key]

    def get_grid(self, key, level: int):
        """The Voronoi nearest-id field of one pyramid level (the ICP
        iterations' neighbour search)."""
        gkey = (key, level)
        if gkey not in self.grids:
            self.grids[gkey] = build_voronoi_nn(
                self.get_pyramid(key)[level], self.config.max_corr_dists[level],
                device=self.device).to(self.device)
        return self.grids[gkey]

    def get_full_grid(self, key):
        """The grid of the whole cloud for the information matrices: the
        Voronoi field, or the exact CSR grid with
        exact_information_matrices."""
        exact = bool(self.config.exact_information_matrices)
        gkey = (key, "full", exact)
        if gkey not in self.grids:
            pts, radius = self.get_points(key), self.config.max_corr_dists[-1]
            grid = (build_grid_nn(pts, radius) if exact
                    else build_voronoi_nn(pts, radius, device=self.device))
            self.grids[gkey] = grid.to(self.device)
        return self.grids[gkey]


def _criteria(config: FragmentPoseRefinementConfig) -> List[ICPConvergenceCriteria]:
    return [ICPConvergenceCriteria(mi, rf, rr) for mi, rf, rr in zip(
        config.max_iterations, config.relative_fitnesses, config.relative_rmses)]


def _converged(icp, config: FragmentPoseRefinementConfig) -> bool:
    return (icp.fitness >= config.icp_fitness_threshold
            or icp.inlier_rmse <= config.icp_inlier_rmse_threshold)


def compute_pcd_pair_edge(cache: _FragmentCache, node_side_index_list: List[Tuple[Side, int]],
                          source_node_index: int, target_node_index: int,
                          config: FragmentPoseRefinementConfig,
                          uncertain: bool) -> Optional[PoseGraphEdge]:
    """One pair's edge, pair by pair (reference
    refine_fragment_poses.py:122-193); None when an uncertain pair fails
    the pre-filter or does not converge."""
    s_key = node_side_index_list[source_node_index]
    t_key = node_side_index_list[target_node_index]
    source = cache.get_points(s_key)
    target = cache.get_points(t_key)
    dev = cache.device

    if config.use_pre_filtering and uncertain:
        pre = evaluate_registration(
            uniform_down_sample(source, config.pre_filter_every_k_points),
            uniform_down_sample(target, config.pre_filter_every_k_points),
            config.pre_filter_max_corr_dist, np.eye(4), device=dev)
        if (pre.fitness < config.pre_filter_fitness_threshold
                or pre.inlier_rmse > config.pre_filter_inlier_rmse_threshold):
            return None

    T = np.eye(4)
    icp = None
    for level, (crit, max_corr) in enumerate(zip(_criteria(config), config.max_corr_dists)):
        icp = registration_icp(cache.get_pyramid(s_key)[level], cache.get_pyramid(t_key)[level],
                               max_corr, init=T, criteria=crit,
                               grid=cache.get_grid(t_key, level), device=dev)
        T = icp.transformation
    if uncertain and not _converged(icp, config):
        return None

    info = get_information_matrix(source, target, config.max_corr_dists[-1],
                                  icp.transformation, grid=cache.get_full_grid(t_key),
                                  device=dev)
    return PoseGraphEdge(source_node_id=source_node_index, target_node_id=target_node_index,
                         transformation=icp.transformation, information=info,
                         uncertain=uncertain)


def _by_target(items, target_of) -> dict:
    groups: dict = {}
    for i in items:
        groups.setdefault(target_of(i), []).append(i)
    return groups


def compute_pcd_pair_edges_batched(cache: _FragmentCache,
                                   node_side_index_list: List[Tuple[Side, int]],
                                   pairs: List[Tuple[int, int, bool]],
                                   config: FragmentPoseRefinementConfig) -> List[PoseGraphEdge]:
    """Every pair's edge with the pairs that share a target batched into one
    ICP per level; the same results as compute_pcd_pair_edge up to the
    float32 sums' order.  Substeps: pair_icp_prefilter, pair_icp_level_<k>
    and pose_graph_information_matrices."""
    dev = cache.device
    criteria = _criteria(config)
    uncertain = [pq for pq in pairs if pq[2]]
    certain = [pq for pq in pairs if not pq[2]]

    # Pre-filter of the uncertain pairs: ICP with max_iteration 0 is the
    # evaluation at the identity (evaluate_registration's statistics).
    if config.use_pre_filtering and uncertain:
        ds_cache: dict = {}

        def ds(node):
            if node not in ds_cache:
                ds_cache[node] = uniform_down_sample(
                    cache.get_points(node_side_index_list[node]),
                    config.pre_filter_every_k_points)
            return ds_cache[node]

        kept = []
        with substep("pair_icp_prefilter"):
            for t, group in _by_target(uncertain, lambda pq: pq[1]).items():
                grid = build_grid_nn(ds(t), config.pre_filter_max_corr_dist).to(dev)
                res = registration_icp_batch_shared(
                    [ds(s) for s, _, _ in group], grid,
                    [config.pre_filter_max_corr_dist] * len(group),
                    criteria=[ICPConvergenceCriteria(0)] * len(group))
                kept += [pq for pq, r in zip(group, res)
                         if r.fitness >= config.pre_filter_fitness_threshold
                         and r.inlier_rmse <= config.pre_filter_inlier_rmse_threshold]
        kept.sort(key=uncertain.index)
        print(f"[Info] Pre-filter kept {len(kept)} / {len(uncertain)} uncertain pairs")
        survivors = certain + kept
    else:
        survivors = list(pairs)
    if not survivors:
        return []

    # Multi-scale ICP, level by level, grouped by shared target.
    T = [np.eye(4) for _ in survivors]
    last: list = [None] * len(survivors)
    groups = _by_target(range(len(survivors)), lambda i: survivors[i][1])
    for level, (crit, max_corr) in enumerate(zip(criteria, config.max_corr_dists)):
        print(f"[Info] Pair ICP level {level + 1}/{len(criteria)}: "
              f"{len(survivors)} pairs in {len(groups)} target groups")
        with substep(f"pair_icp_level_{level + 1}"):
            for t_n, idxs in groups.items():
                res = registration_icp_batch_shared(
                    [cache.get_pyramid(node_side_index_list[survivors[i][0]])[level]
                     for i in idxs],
                    cache.get_grid(node_side_index_list[t_n], level),
                    [max_corr] * len(idxs), inits=[T[i] for i in idxs],
                    criteria=[crit] * len(idxs))
                for i, r in zip(idxs, res):
                    T[i] = r.transformation
                    last[i] = r

    # Convergence gate, then the information matrices per shared target.
    kept_idx = [i for i, (_, _, unc) in enumerate(survivors)
                if not unc or _converged(last[i], config)]
    info: dict = {}
    with substep("pose_graph_information_matrices"):
        for t_n, idxs in _by_target(kept_idx, lambda i: survivors[i][1]).items():
            infos = get_information_matrix_batch(
                [cache.get_points(node_side_index_list[survivors[i][0]]) for i in idxs],
                cache.get_full_grid(node_side_index_list[t_n]), config.max_corr_dists[-1],
                [last[i].transformation for i in idxs])
            info.update(zip(idxs, infos))
    for i, (s, t, _) in enumerate(survivors):
        r = last[i]
        print(f"[Info] Pair ({s}, {t}): fitness {r.fitness:.6f}, inlier rmse "
              f"{r.inlier_rmse:.6f}{'' if i in info else ' (not converged, dropped)'}")
    return [PoseGraphEdge(source_node_id=survivors[i][0], target_node_id=survivors[i][1],
                          transformation=last[i].transformation, information=info[i],
                          uncertain=survivors[i][2]) for i in kept_idx]


def build_pose_graph_for_scene(recon_data_io: ReconstructionDataIO,
                               fragment_counts: Dict[Side, int],
                               config: FragmentPoseRefinementConfig,
                               device="cuda") -> Tuple[PoseGraph, List[Tuple[Side, int]]]:
    """The scene pose graph over every fragment (reference
    refine_fragment_poses.py:196-271): sequential pairs per side, then
    every pair as an uncertain loop."""
    pose_graph = PoseGraph()
    node_side_index_list: List[Tuple[Side, int]] = []
    node_map: Dict[Tuple[Side, int], int] = {}
    for side, count in fragment_counts.items():
        for index in range(count):
            node_map[(side, index)] = len(node_side_index_list)
            node_side_index_list.append((side, index))
            pose_graph.nodes.append(np.eye(4))

    pairs = []
    for side, count in fragment_counts.items():
        pairs += [(node_map[(side, i)], node_map[(side, i + 1)], False)
                  for i in range(count - 1)]
    n = len(node_side_index_list)
    pairs += [(i, j, True) for i, j in itertools.combinations(range(n), 2)]

    cache = _FragmentCache(recon_data_io, config, device=device)
    if config.batch_pair_icp:
        edges = compute_pcd_pair_edges_batched(cache, node_side_index_list, pairs, config)
    else:
        edges = [e for s, t, unc in pairs if (e := compute_pcd_pair_edge(
            cache, node_side_index_list, s, t, config, unc)) is not None]
    print(f"[Info] Valid edges: {len(edges)} / {len(pairs)}")
    pose_graph.edges.extend(edges)
    return pose_graph, node_side_index_list


def refine_fragment_poses(depth_data_io: DepthDataIO, recon_data_io: ReconstructionDataIO,
                          fragment_dataset_map: Dict[Side, List[DepthDataset]],
                          config: FragmentPoseRefinementConfig, device="cuda") -> None:
    """Step 2's scene level on `device` (reference
    refine_fragment_poses.py:274-321): the fragments' poses in
    fragment_dataset_map are updated in place."""
    dev = resolve_device(device)
    with substep("integrate_fragment_point_clouds"):
        fragment_counts = integrate_and_save_fragment_point_clouds(
            depth_data_io, recon_data_io, fragment_dataset_map, config, device=dev)
    with substep("build_scene_pose_graph"):
        pose_graph, node_side_index_list = build_pose_graph_for_scene(
            recon_data_io, fragment_counts, config, device=dev)
    option = GlobalOptimizationOption(
        max_correspondence_distance=config.dist_threshold,
        edge_prune_threshold=config.edge_prune_threshold, reference_node=0)
    n_edges = len(pose_graph.edges)
    with substep("scene_global_optimization"):
        global_optimization(pose_graph, option, device=dev)
    print(f"[Info] Scene pose graph: {len(pose_graph.nodes)} nodes, {n_edges} edges, "
          f"{n_edges - len(pose_graph.edges)} pruned")

    fragment_transforms = convert_pose_graph_to_transforms(pose_graph)
    for node_index, (side, side_index) in enumerate(node_side_index_list):
        frag = fragment_dataset_map[side][side_index]
        frag.transforms = frag.transforms.apply_world_transform(
            delta_position=fragment_transforms.positions[node_index],
            delta_rotation=fragment_transforms.rotations[node_index])
