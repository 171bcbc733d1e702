"""SE(3) / se(3) math for pose-graph optimization and ICP.

The reference leans on Open3D's C++ GlobalOptimization/ICP internals for all
Lie-group work (reference: scripts/processing/reconstruction/depth_optimization/
make_fragments.py:259-269, refine_fragment_poses.py:298-308).  We need
exp/log maps and pose composition as batched primitives so the Gauss-Newton /
Levenberg-Marquardt solvers of ops/posegraph.py and ops/icp.py can run on
the card; the same functions run on host numpy (geometry/_dispatch).

Twist convention: xi = (omega, upsilon) with rotation first — matching the
standard Open3D/Sophus ordering used in pose-graph Jacobians.
Poses are (..., 4, 4) homogeneous matrices.
"""

from __future__ import annotations

from mq3d_tpu_torch.geometry._dispatch import get_namespace

_EPS = 1e-10


def hat(omega):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    xp = get_namespace(omega)
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = xp.zeros_like(ox)
    return xp.stack(
        [
            xp.stack([zeros, -oz, oy], axis=-1),
            xp.stack([oz, zeros, -ox], axis=-1),
            xp.stack([-oy, ox, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(m):
    """(..., 3, 3) skew matrix -> (..., 3) vector."""
    xp = get_namespace(m)
    return xp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def _theta(omega):
    """Safe rotation angle: (..., 1, 1). Returns (theta, theta_safe, small)
    where theta_safe is gradient-safe (norm never differentiated at 0)."""
    xp = get_namespace(omega)
    sq = xp.sum(omega * omega, axis=-1)[..., None, None]
    small = sq < 1e-10
    theta_safe = xp.sqrt(xp.where(small, 1.0, sq))
    theta = xp.where(small, xp.sqrt(sq + _EPS ** 2), theta_safe)
    return theta, theta_safe, small


def so3_exp(omega):
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation.

    All small-angle branches use the double-where pattern so a Jacobian
    (torch.func.jacrev) stays NaN-free at omega = 0, as the pose-graph
    solver needs.
    """
    xp = get_namespace(omega)
    theta, ts, small = _theta(omega)
    K = hat(omega)
    K2 = K @ K
    eye = xp.broadcast_to(xp.eye(3, dtype=omega.dtype), K.shape)
    t2 = theta * theta
    a = xp.where(small, 1.0 - t2 / 6.0, xp.sin(ts) / ts)
    b = xp.where(small, 0.5 - t2 / 24.0, (1.0 - xp.cos(ts)) / (ts * ts))
    return eye + a * K + b * K2


def so3_log(R):
    """(..., 3, 3) rotation -> (..., 3) axis-angle (theta in [0, pi]).

    Gradient-safe at theta -> 0 (double-where around arccos/sin)."""
    xp = get_namespace(R)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = xp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - xp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis

    small = cos_theta > 1.0 - 1e-10  # theta < ~1.4e-5
    near_pi_c = cos_theta < -1.0 + 1e-7
    cos_safe = xp.where(small | near_pi_c, 0.0, cos_theta)
    theta_exact = xp.arccos(cos_safe)
    # Endpoint-safe theta: sqrt-based expansions at both cos = +-1 keep
    # gradients finite (arccos' derivative diverges at the endpoints and
    # would leak NaN through the untaken where-branches).
    theta_small = xp.sqrt(xp.maximum(2.0 * (1.0 - cos_theta), 0.0) + _EPS ** 2)
    theta_pi = 3.141592653589793 - xp.sqrt(
        xp.maximum(2.0 * (1.0 + cos_theta), 0.0) + _EPS ** 2
    )
    theta = xp.where(small, theta_small, xp.where(near_pi_c, theta_pi, theta_exact))
    near_pi = near_pi_c | (theta > 3.14159265 - 1e-4)

    sin_safe = xp.sin(xp.where(small | near_pi_c, xp.ones_like(theta_exact) * 0.5,
                               theta_exact))
    # Small angle: omega = w * (1 + |w|^2 / 6) with |w| ~ theta.
    w2 = xp.sum(w * w, axis=-1)
    scale = xp.where(
        small,
        1.0 + w2 / 6.0,
        xp.where(near_pi_c, 1.0, theta_exact / sin_safe),
    )
    omega_generic = w * scale[..., None]

    # Near pi the generic formula loses the axis (sin(theta) -> 0).  Recover
    # the axis from (R + I), whose columns are all parallel to the axis there:
    # pick the column with the largest diagonal entry for stability.
    RI = R + xp.broadcast_to(xp.eye(3, dtype=R.dtype), R.shape)
    diag = xp.stack([RI[..., 0, 0], RI[..., 1, 1], RI[..., 2, 2]], axis=-1)
    k = xp.argmax(diag, axis=-1)
    col = xp.take_along_axis(RI, k[..., None, None], axis=-1)[..., 0]  # (..., 3)
    col_norm = xp.sqrt(xp.sum(col * col, axis=-1, keepdims=True) + _EPS ** 2)
    axis_pi = col / col_norm
    # Resolve the overall sign with the (tiny but directional) skew part.
    dot_w = xp.sum(axis_pi * w, axis=-1, keepdims=True)
    axis_pi = xp.where(dot_w < 0, -axis_pi, axis_pi)
    omega_pi = axis_pi * theta[..., None]

    return xp.where(near_pi[..., None], omega_pi, omega_generic)


def _jacobian_coeffs(omega):
    xp = get_namespace(omega)
    theta, ts, small = _theta(omega)
    t2 = theta * theta
    b = xp.where(small, 0.5 - t2 / 24.0, (1.0 - xp.cos(ts)) / (ts * ts))
    c = xp.where(small, 1.0 / 6.0 - t2 / 120.0, (ts - xp.sin(ts)) / (ts * ts * ts))
    return b, c


def _left_jacobian(omega):
    """SO(3) left Jacobian J_l(omega): translation coupling of se3_exp."""
    xp = get_namespace(omega)
    K = hat(omega)
    K2 = K @ K
    eye = xp.broadcast_to(xp.eye(3, dtype=omega.dtype), K.shape)
    b, c = _jacobian_coeffs(omega)
    return eye + b * K + c * K2


def _left_jacobian_inv(omega):
    xp = get_namespace(omega)
    theta, ts, small = _theta(omega)
    K = hat(omega)
    K2 = K @ K
    eye = xp.broadcast_to(xp.eye(3, dtype=omega.dtype), K.shape)
    t2 = theta * theta
    half = ts * 0.5
    cot_term = xp.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * xp.cos(half) / xp.sin(half)) / (ts * ts),
    )
    return eye - 0.5 * K + cot_term * K2


def se3_exp(xi):
    """(..., 6) twist (omega, upsilon) -> (..., 4, 4) pose."""
    xp = get_namespace(xi)
    omega = xi[..., :3]
    upsilon = xi[..., 3:]
    R = so3_exp(omega)
    t = (_left_jacobian(omega) @ upsilon[..., None])[..., 0]
    top = xp.concatenate([R, t[..., None]], axis=-1)
    bottom = xp.broadcast_to(
        xp.asarray([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype), top.shape[:-2] + (1, 4)
    )
    return xp.concatenate([top, bottom], axis=-2)


def se3_log(T):
    """(..., 4, 4) pose -> (..., 6) twist (omega, upsilon).

    Inverse of se3_exp for rotation angles < pi.
    """
    xp = get_namespace(T)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    upsilon = (_left_jacobian_inv(omega) @ t[..., None])[..., 0]
    return xp.concatenate([omega, upsilon], axis=-1)


def se3_inverse(T):
    """Batched rigid-pose inverse without linalg.inv."""
    xp = get_namespace(T)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = xp.swapaxes(R, -1, -2)
    t_inv = -(Rt @ t[..., None])[..., 0]
    top = xp.concatenate([Rt, t_inv[..., None]], axis=-1)
    bottom = xp.broadcast_to(
        xp.asarray([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), top.shape[:-2] + (1, 4)
    )
    return xp.concatenate([top, bottom], axis=-2)


def transform_points(T, points):
    """Apply (..., 4, 4) pose to (..., N, 3) points."""
    xp = get_namespace(T, points)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ xp.swapaxes(R, -1, -2) + t[..., None, :]
