"""Coordinate-system conventions and conversion matrices.

Encodes the exact basis matrices of the reference implementation
(reference: scripts/models/transforms.py:132-161).  These conventions are
where bit-parity with the reference pipeline is won or lost, so the numbers
here are covered by closed-form unit tests.

World bases (as expressed in the internal canonical frame):
  UNITY       X-right, Y-up, Z-forward (left-handed)     -> identity
  OPEN3D      X-right, Y-up, Z-backward (right-handed)   -> diag(1, 1, -1)
  NERFSTUDIO  X-right, Y-forward, Z-up (right-handed)    -> permutation
  COLMAP      X-right, Y-down, Z-forward (right-handed)  -> diag(1, -1, 1)

Camera bases (camera axes expressed in that system's world basis):
  UNITY   X-right, Y-up, Z-forward        -> identity
  OPEN3D  X-right, Y-down, Z-forward      -> diag(1, -1, -1)
  NERF    X-right, Y-up, Z-backward       -> permutation with sign
  COLMAP  X-right, Y-down, Z-forward      -> identity
"""

from __future__ import annotations

from enum import Enum

import numpy as np


class CoordinateSystem(Enum):
    UNITY = "Unity"
    OPEN3D = "Open3D"
    NERFSTUDIO = "NerfStudio"
    COLMAP = "COLMAP"


_WORLD_BASIS = {
    CoordinateSystem.UNITY: np.eye(3),
    CoordinateSystem.OPEN3D: np.diag((1.0, 1.0, -1.0)),
    CoordinateSystem.NERFSTUDIO: np.array(
        [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]
    ),
    CoordinateSystem.COLMAP: np.diag((1.0, -1.0, 1.0)),
}

_CAMERA_BASIS = {
    CoordinateSystem.UNITY: np.eye(3),
    CoordinateSystem.OPEN3D: np.diag((1.0, -1.0, -1.0)),
    CoordinateSystem.NERFSTUDIO: np.array(
        [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]]
    ),
    CoordinateSystem.COLMAP: np.eye(3),
}


def world_basis(cs: CoordinateSystem) -> np.ndarray:
    return _WORLD_BASIS[cs].copy()


def camera_basis(cs: CoordinateSystem) -> np.ndarray:
    return _CAMERA_BASIS[cs].copy()


def coordinate_transform_matrix(
    source: CoordinateSystem, target: CoordinateSystem
) -> np.ndarray:
    """R_conv mapping world vectors from `source` to `target` convention."""
    return world_basis(target) @ world_basis(source).T
