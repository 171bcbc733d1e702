"""K4: the correctly rounded float32 a*b + c on the card, in one pass.

`ops.tsdf._fma` is the port's fused multiply-add, the operation XLA's
compilers contract `a*b + c` into.  For CUDA tensors it launches the
hand-written kernel csrc/fma.cu (`fma_cuda`), whose `__fmaf_rn` is
correctly rounded by definition; for CPU tensors it runs its plain
version, the float64 emulation `ops.tsdf._fma_plain`.  Both give the same
bits.

`check_operands` lets through what both paths take: float32 tensors on
one device (the CPU or a card), of any shapes that broadcast.  Anything
else raises, a Python or numpy scalar too: no caller passes one, and the
plain version would compute with a scalar's float64 value, the kernel
with a rounded one.

`fma_cuda` reads each operand through its own strides over the broadcast
shape: a broadcast or `.expand`ed dimension has stride 0 and is never
materialised.  `merge_layout` drops size-1 dimensions and merges the ones
every operand lets it merge; the rest (at most MAX_DIMS) go to the kernel
by value, innermost first.  The launch sits in the operator-scope profiler
record "mq3d::fma" (`_build.launch_record`), so torch.profiler links the
kernel to the "fma" span that `_fma` opens around it.
"""

from __future__ import annotations

import ctypes

import torch

from mq3d_tpu_torch.kernels import _build

MAX_DIMS = 6  # kMaxDims of csrc/fma.cu


def check_operands(a, b, c) -> None:
    """Raise unless a, b and c are float32 tensors on one device."""
    for t in (a, b, c):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"_fma takes float32 tensors, got {type(t).__name__}")
    device = a.device
    for t in (a, b, c):
        if t.dtype != torch.float32:
            raise TypeError(f"_fma takes float32 operands, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"_fma: operands on {device} and {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"_fma: unsupported device {device}")


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
                raise ValueError(f"_fma: shapes {[tuple(s) for s in shapes]} do not broadcast")
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
        raise ValueError(f"_fma: {ndim} dimensions left after merging, the kernel takes "
                         f"{MAX_DIMS}")
    lib = _build.library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with _build.launch_record("mq3d::fma"):
        err = lib.mq3d_fma(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), ndim,
                           (ctypes.c_longlong * max(ndim, 1))(*sizes),
                           (ctypes.c_longlong * max(3 * ndim, 1))(
                               *(x for s in strides for x in s)),
                           stream)
    _build.check(err, "fma")
    _build.count_launch("fma")
    return out
