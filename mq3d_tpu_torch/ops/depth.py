"""Depth conversions: Quest NDC depth -> metric linear depth.

Closed-form re-implementation of the reference math
(reference: scripts/utils/depth_utils.py:21-47), written as array ops that
run batched over whole frame stacks, on numpy arrays or torch tensors.

The Quest depth sensor stores reversed-NDC depth d in [0, 1]; with projection
params derived from (near, far) the metric depth is x / (2d - 1 + y).
"""

from __future__ import annotations

import numpy as np

from mq3d_tpu_torch.geometry._dispatch import get_namespace


def ndc_to_linear_params(near, far):
    """Projection params (x, y) for NDC->linear (reference depth_utils.py:21-28).

    Handles the infinite-far-plane case.  Works on scalars or arrays.
    """
    xp = get_namespace(near, far)
    near = xp.asarray(near, dtype=xp.float64)
    far = xp.asarray(far, dtype=xp.float64)
    # <= (reference uses <): far == near would divide by zero below; the
    # degenerate plane pair falls back to the infinite-far model.
    inf_far = xp.isinf(far) | (far <= near)
    x = xp.where(inf_far, -2.0 * near, -2.0 * far * near / xp.where(inf_far, 1.0, far - near))
    y = xp.where(inf_far, -1.0, -(far + near) / xp.where(inf_far, 1.0, far - near))
    return x, y


def to_linear_depth(d, x, y):
    """NDC depth buffer -> metric depth: x / (2d - 1 + y), 0 where singular
    (reference depth_utils.py:31-39)."""
    xp = get_namespace(d)
    ndc = d * 2.0 - 1.0
    denom = ndc + y
    safe = xp.where(denom == 0, 1.0, denom)
    return xp.where(denom == 0, 0.0, x / safe)


def convert_depth_to_linear(depth_buffer, near, far):
    """Full conversion, float32 output (reference depth_utils.py:42-47).

    `near`/`far` may be scalars or per-frame arrays broadcast against a
    (N, H, W) stack of depth buffers.
    """
    xp = get_namespace(depth_buffer)
    x, y = ndc_to_linear_params(near, far)
    if hasattr(x, "ndim") and x.ndim == 1 and depth_buffer.ndim == 3:
        x = x[:, None, None]
        y = y[:, None, None]
    out = to_linear_depth(depth_buffer, x, y)
    return out.astype(np.float32) if xp is np else out.to(xp.float32)


def linear_depth_to_png_values(depth_map, clip_near: float, clip_far: float):
    """Metric depth -> 8-bit visualization values (reference:
    scripts/processing/depth_conversion/convert_depth_to_linear.py:39)."""
    xp = get_namespace(depth_map)
    return xp.clip((depth_map - clip_near) / (clip_far - clip_near), 0, 1) * 255.0


def is_depth_map_valid(depth_map: np.ndarray) -> bool:
    """Sensor-dropout check (reference: scripts/dataio/depth_data_io.py:80-85):
    a frame that is all-0, all-1, contains NaNs, or negatives is rejected."""
    return bool(
        (depth_map != 0).any()
        and (depth_map != 1).any()
        and not np.isnan(depth_map).any()
        and (depth_map >= 0).all()
    )
