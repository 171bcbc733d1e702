"""The port's float32 arithmetic in XLA's CPU order, and K4, the correctly
rounded a*b + c on the card in one pass.

XLA's CPU compiler contracts `a*b + c` into a fused multiply-add, so the
JAX build's projections, pose transforms and merges are FMA chains.  `fma`
gives their bits on every device: CUDA tensors launch K4 (csrc/fma.cu,
`fma_cuda`), whose `__fmaf_rn` is correctly rounded by definition; CPU
tensors run its plain version `fma_plain`, which rounds the exact float64
product's sum to odd before rounding to float32.  The chains built on it
(`rotate_add`, `apply_pose`, `norm3`) take XLA's order; `to_i32` and
`sqrt_rn` give XLA's conversion and a correctly rounded root.  Divisions
never take a Python scalar divisor (`f32_scalar`): CUDA PyTorch turns
x / s into x * (1/s), which is not the correctly rounded quotient.

`check_operands` lets through float32 tensors on one device (the CPU or a
card), of shapes that broadcast.  Anything else raises, a Python or numpy
scalar too: the plain version would compute with its float64 value, the
kernel with a rounded one.  `fma_cuda` reads each operand through its
strides over the broadcast shape (0 along a broadcast dimension, never
materialised); `merge_layout` drops size-1 dimensions and merges those
every operand lets it merge, and the rest (at most MAX_DIMS) go to the
kernel innermost first.  The launch's record "mq3d::fma" (`_build.launch`)
links the kernel to the "fma" span that `fma` opens around it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.utils.log import span

MAX_DIMS = 6  # kMaxDims of csrc/fma.cu


def check_operands(a, b, c) -> None:
    """Raise unless a, b and c are float32 tensors on one device."""
    for t in (a, b, c):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fma takes float32 tensors, got {type(t).__name__}")
    device = a.device
    for t in (a, b, c):
        if t.dtype != torch.float32:
            raise TypeError(f"fma takes float32 operands, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"fma: operands on {device} and {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fma: unsupported device {device}")


def broadcast_shape(*shapes) -> tuple:
    """The broadcast of `shapes`, as torch.broadcast_shapes gives it, in
    plain Python: torch's imports sympy on its first call, about 5 s of a
    process's set-up on the card's host."""
    nd = max(len(s) for s in shapes)
    out = []
    for d in range(nd):
        n = 1
        for s in shapes:
            k = d - nd + len(s)
            if k < 0 or s[k] == 1:
                continue
            if n != 1 and s[k] != n:
                raise ValueError(f"fma: shapes {[tuple(s) for s in shapes]} do not broadcast")
            n = s[k]
        out.append(n)
    return tuple(out)


def broadcast_strides(t: torch.Tensor, shape) -> list:
    """t's strides over the broadcast `shape`: 0 along each dimension that t
    broadcasts (size 1 or missing), as `t.expand(shape).stride()`."""
    lead = len(shape) - t.dim()
    st = [0] * lead
    for n, s in zip(t.shape, t.stride()):
        st.append(s if n != 1 else 0)
    return st


def merge_layout(shape, strides):
    """(sizes, per-operand strides), both innermost first, of the same
    elements in the same order: size-1 dimensions dropped, and a dimension
    merged into the one inside it where every operand's stride along it is
    the inner stride times the inner size."""
    sizes, merged = [], [[] for _ in strides]
    for d in reversed(range(len(shape))):
        n = shape[d]
        if n == 1:
            continue
        if sizes and all(s[d] == m[-1] * sizes[-1] for s, m in zip(strides, merged)):
            sizes[-1] *= n
            continue
        sizes.append(n)
        for s, m in zip(strides, merged):
            m.append(s[d])
    return sizes, merged


def fma_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once, by K4: float32 CUDA tensors on one device
    (`check_operands`), broadcast; a fresh contiguous float32 result."""
    shape = broadcast_shape(a.shape, b.shape, c.shape)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:  # nothing to launch
        return out
    sizes, strides = merge_layout(shape, [broadcast_strides(t, shape) for t in (a, b, c)])
    ndim = len(sizes)
    if ndim > MAX_DIMS:
        raise ValueError(f"fma: {ndim} dimensions left after merging, the kernel takes "
                         f"{MAX_DIMS}")
    _build.launch("fma", a.device, a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
                  ndim, (ctypes.c_longlong * max(ndim, 1))(*sizes),
                  (ctypes.c_longlong * max(3 * ndim, 1))(*(x for s in strides for x in s)))
    return out


def fma_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c, correctly rounded, in plain PyTorch: the CPU path of
    `fma`, and its kernel's reference on the card.

    The float32 product is exact in float64.  The float64 sum s = p + c is
    rounded to odd: when its TwoSum error e is non-zero and the last
    mantissa bit of s is 0, s steps one float64 ulp toward e.  A value
    rounded to odd with 53 >= 24 + 2 bits rounds to float32 as the exact
    sum would, so the result is the singly rounded one on every device.
    Where s is inf or NaN, e is NaN and s is kept.  Every operand is made
    float64 itself: by PyTorch's type promotion a float64 0-d `a` times a
    float32 `b` with dimensions would be a float32 product."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bp = s - p
    e = (p - (s - bp)).add_(c - bp)
    step = (e.abs() > 0).logical_and_((s.view(torch.int64) & 1) == 0)
    return torch.where(step, torch.nextafter(s, e * math.inf), s).float()


def fma(a, b, c) -> torch.Tensor:
    """float32 a*b + c, correctly rounded, as XLA's fused multiply-add
    computes it (see module doc): CUDA tensors launch K4 (`fma_cuda`), CPU
    tensors take `fma_plain`.

    Operands are float32 tensors on one device, broadcasting
    (`check_operands`); anything else raises, a Python scalar too.  Under
    a profiler the call sits in a range named "fma"."""
    with span("fma"):
        check_operands(a, b, c)
        if a.device.type == "cuda":
            return fma_cuda(a, b, c)
        return fma_plain(a, b, c)


def f32_scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on `like`'s device (a divisor that is not a
    Python scalar; see module doc)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def rotate_add(R, x, y, z, t):
    """R[0]*x + R[1]*y + R[2]*z + t in the reference's FMA order:
    fma(R2, z, fma(R0, x, R1*y)) + t."""
    return fma(R[2], z, fma(R[0], x, R[1] * y)) + t


def apply_pose(p: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """float32 p @ T[:3, :3].T + T[:3, 3] for points p (..., 3) and poses T
    broadcastable to (..., 4, 4), in the order XLA's CPU dot takes it:
    fma(p2, R_i2, fma(p1, R_i1, p0 * R_i0)) + t_i."""
    out = [fma(p[..., 2], T[..., i, 2], fma(p[..., 1], T[..., i, 1], p[..., 0] * T[..., i, 0]))
           + T[..., i, 3] for i in range(3)]
    return torch.stack(out, dim=-1)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: saturating to [INT_MIN, INT_MAX],
    NaN -> 0.  A plain cast of an out-of-range float gives INT_MIN on the
    CPU and saturates on the card."""
    x = torch.nan_to_num(x, nan=0.0)
    # 2147483520 is the largest float32 below 2^31.
    out = x.clamp(-2.0 ** 31, 2147483520.0).to(torch.int32)
    return torch.where(x >= 2.0 ** 31, torch.iinfo(torch.int32).max, out)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded on every device.  The card's float32
    sqrt is not (it is one ulp off the CPU's on some inputs); its float64
    sqrt is, and rounding that to float32 keeps it correct
    (53 >= 2 * 24 + 2)."""
    return torch.sqrt(x.double()).float()


def norm3(v: torch.Tensor) -> torch.Tensor:
    """float32 |v| over the last axis (size 3) as XLA's CPU reduction
    contracts it: sqrt(fma(v2, v2, fma(v1, v1, v0 * v0))), elementwise, so
    the same on every device."""
    return sqrt_rn(fma(v[..., 2], v[..., 2], fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0])))
