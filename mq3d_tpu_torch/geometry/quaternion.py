"""Quaternion math (xyzw order, Hamilton convention), scipy-compatible.

The reference delegates all quaternion work to scipy.spatial.transform.Rotation
(reference: scripts/models/transforms.py:111-129, 186-201).  We re-implement
it as pure array functions that run both on torch tensors and on
host numpy (see geometry/_dispatch.py); tests validate agreement with scipy.

Conventions (must match scipy exactly):
  - quaternions are (..., 4) arrays in (x, y, z, w) order
  - q represents a rotation; `rotate(q, v)` == scipy `R.from_quat(q).apply(v)`
  - `multiply(q1, q2)` == scipy `(R1 * R2).as_quat()` up to sign
"""

from __future__ import annotations

from mq3d_tpu_torch.geometry._dispatch import get_namespace


def normalize(q):
    """Normalize quaternion(s) to unit norm."""
    xp = get_namespace(q)
    return q / xp.linalg.norm(q, axis=-1, keepdims=True)


def conjugate(q):
    """Quaternion conjugate: negate the vector part (x, y, z).

    For unit quaternions this is the inverse (reference:
    scripts/models/transforms.py:122-129 `invert_quaternions`).
    """
    xp = get_namespace(q)
    return xp.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def multiply(q1, q2):
    """Hamilton product in xyzw order; matches scipy `R1 * R2`.

    The composed rotation applies q2 first, then q1 (matrix order R1 @ R2).
    """
    xp = get_namespace(q1, q2)
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return xp.stack([x, y, z, w], axis=-1)


def rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q.

    Equivalent to `as_matrix(q) @ v` but without forming the matrix:
    v' = v + 2 * (w * cross(q_vec, v) + cross(q_vec, cross(q_vec, v))).
    Broadcasts over leading dims of both arguments.
    """
    xp = get_namespace(q, v)
    q_vec = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * xp.cross(q_vec, v)
    return v + w * t + xp.cross(q_vec, t)


def as_matrix(q):
    """Quaternion -> (..., 3, 3) rotation matrix; matches scipy `as_matrix`."""
    xp = get_namespace(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return xp.stack(
        [
            xp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            xp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            xp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def from_matrix(m):
    """(..., 3, 3) rotation matrix -> unit quaternion (xyzw).

    Branchless Shepperd method: build all four candidate quaternions and
    select the one keyed on the largest of (m00, m11, m22, trace), which is
    numerically safest and matches scipy's construction.
    """
    xp = get_namespace(m)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22

    qw = xp.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], axis=-1)
    qx = xp.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], axis=-1)
    qy = xp.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], axis=-1)
    qz = xp.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], axis=-1)

    decisions = xp.stack([m00, m11, m22, tr], axis=-1)
    choice = xp.argmax(decisions, axis=-1)

    cands = xp.stack([qx, qy, qz, qw], axis=-2)  # (..., 4 candidates, 4)
    q = xp.take_along_axis(cands, choice[..., None, None], axis=-2)[..., 0, :]
    return normalize(q)


def slerp(q0, q1, alpha):
    """Spherical linear interpolation, matching scipy Slerp semantics.

    alpha in [0, 1]; broadcasts over leading dims.
    """
    xp = get_namespace(q0, q1)
    dot = xp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = xp.where(dot < 0.0, -q1, q1)
    dot = xp.clip(xp.abs(dot), -1.0, 1.0)
    theta = xp.arccos(dot)
    sin_theta = xp.sin(theta)
    small = sin_theta < 1e-7
    safe = xp.where(small, 1.0, sin_theta)
    w0 = xp.where(small, 1.0 - alpha, xp.sin((1.0 - alpha) * theta) / safe)
    w1 = xp.where(small, alpha, xp.sin(alpha * theta) / safe)
    return normalize(w0 * q0 + w1 * q1)
