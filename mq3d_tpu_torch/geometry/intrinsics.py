"""Pinhole intrinsics helpers.

Includes the two convention-critical formulas of the reference:

  * depth camera intrinsics from FOV tangents
    (reference: scripts/utils/depth_utils.py:4-18)
  * the Open3D-facing principal-point mirror flip ``cx' = width - cx``
    (reference: scripts/processing/reconstruction/utils/o3d_utils.py:14-19)

Works on numpy arrays (pure array ops).
"""

from __future__ import annotations

import numpy as np


def depth_camera_params(left, right, top, bottom, width, height):
    """Intrinsics (fx, fy, cx, cy) from half-FOV tangents and image size."""
    fx = width / (right + left)
    fy = height / (top + bottom)
    cx = width * right / (right + left)
    cy = height * top / (top + bottom)
    return fx, fy, cx, cy


def intrinsic_matrices(fx, fy, cx, cy) -> np.ndarray:
    """Stack per-frame (3, 3) K matrices from per-frame scalars."""
    fx = np.asarray(fx, dtype=np.float32)
    n = fx.shape[0]
    K = np.zeros((n, 3, 3), dtype=np.float32)
    K[:, 0, 0] = fx
    K[:, 1, 1] = fy
    K[:, 2, 2] = 1.0
    K[:, 0, 2] = cx
    K[:, 1, 2] = cy
    return K


def mirror_cx(K: np.ndarray, widths) -> np.ndarray:
    """Apply the reference's horizontal principal-point flip.

    The Quest capture images are horizontally mirrored relative to the
    Open3D camera convention; the reference compensates by remapping
    cx -> width - cx before any Open3D call
    (reference: o3d_utils.py:14-19 `compute_o3d_intrinsic_matrices`).
    """
    K = np.array(K, copy=True)
    K[:, 0, 2] = np.asarray(widths) - K[:, 0, 2]
    return K
