"""Transforms <-> pose-graph conversions (counterpart of
mq3d_tpu/recon/graph_utils.py; reference o3d_utils.py:22-106)."""

from __future__ import annotations

import numpy as np

from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.models.transforms import CoordinateSystem, Transforms
from mq3d_tpu_torch.ops.posegraph import PoseGraph


def convert_transforms_to_pose_graph(transforms: Transforms) -> PoseGraph:
    pg = PoseGraph()
    pg.nodes = [np.asarray(p, np.float64) for p in transforms.extrinsics_cw]
    return pg


def convert_pose_graph_to_transforms(pose_graph: PoseGraph) -> Transforms:
    poses = np.stack([np.asarray(n, np.float64) for n in pose_graph.nodes])
    return Transforms(
        coordinate_system=CoordinateSystem.OPEN3D,
        positions=poses[:, :3, 3],
        rotations=np.asarray(quat.from_matrix(poses[:, :3, :3])),
    )
