"""K1: the per-pair depth-patch lookup of TSDF integration.

Counterpart of mq3d_tpu/ops/tsdf_pallas.py (`patch_lookup`, the Pallas
kernel `_lookup_kernel`).  Each (window-block, frame) pair of integration
has a PSxPS depth patch anchored at the block's projected centre; every
voxel of the block fetches its nearest depth from it:

    out[p, v] = patch[p, vi[p, v], ui[p, v]]   if 0 <= vi, ui < PS
              = 0.0                            otherwise

`patch_lookup` launches the hand-written CUDA kernel (csrc/patch_lookup.cu)
for tensors on the card and runs `patch_lookup_plain` for tensors on the
CPU; anything else raises.  The kernel has none of the Pallas block
constraints (TP % 8, V % 128): any TP, V and PS up to 238 work, aligned
or not (misaligned rows or odd PS take the kernel's scalar path).
"""

from __future__ import annotations

import torch

from mq3d_tpu_torch.kernels import _build

# Largest patch whose float32 tile fits one block's shared memory (227 KB).
_MAX_PS = 238


def patch_lookup_plain(patch: torch.Tensor, vi: torch.Tensor,
                       ui: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (TP,PS,PS) f32, (TP,V) i32 x2 -> (TP,V) f32."""
    TP, PS, _ = patch.shape
    in_patch = (vi >= 0) & (vi < PS) & (ui >= 0) & (ui < PS)
    flat = vi.clamp(0, PS - 1).long() * PS + ui.clamp(0, PS - 1).long()
    d = torch.gather(patch.reshape(TP, PS * PS), 1, flat)
    return torch.where(in_patch, d, torch.zeros((), dtype=d.dtype, device=d.device))


def _check(patch, vi, ui):
    if patch.dtype != torch.float32 or vi.dtype != torch.int32 or ui.dtype != torch.int32:
        raise TypeError(
            f"patch_lookup takes float32 patch and int32 indices, got "
            f"{patch.dtype}, {vi.dtype}, {ui.dtype}")
    if patch.ndim != 3 or patch.shape[1] != patch.shape[2]:
        raise ValueError(f"patch must be (TP, PS, PS), got {tuple(patch.shape)}")
    if vi.ndim != 2 or vi.shape != ui.shape or vi.shape[0] != patch.shape[0]:
        raise ValueError(
            f"indices must be (TP, V) matching patch {tuple(patch.shape)}, got "
            f"{tuple(vi.shape)} and {tuple(ui.shape)}")
    if not (patch.device == vi.device == ui.device):
        raise ValueError("patch and indices must lie on one device")


def patch_lookup(patch: torch.Tensor, vi: torch.Tensor,
                 ui: torch.Tensor) -> torch.Tensor:
    """Per-pair patch gather: (TP,PS,PS) f32, (TP,V) i32 x2 -> (TP,V) f32.

    CUDA tensors launch K1; CPU tensors take the plain version."""
    _check(patch, vi, ui)
    if patch.device.type == "cpu":
        return patch_lookup_plain(patch, vi, ui)
    if patch.device.type != "cuda":
        raise ValueError(f"patch_lookup: unsupported device {patch.device}")
    TP, PS, _ = patch.shape
    V = vi.shape[1]
    if PS > _MAX_PS:
        raise ValueError(f"patch size {PS} exceeds the kernel's {_MAX_PS}")
    if max(TP * PS * PS, TP * V) >= 2 ** 31:
        raise ValueError(f"patch_lookup: shape too large ({TP}, {PS}, {V})")
    patch = patch.contiguous()
    vi = vi.contiguous()
    ui = ui.contiguous()
    out = torch.empty((TP, V), dtype=torch.float32, device=patch.device)
    if out.numel() == 0:  # nothing to launch
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(patch.device).cuda_stream
    err = lib.mq3d_patch_lookup(
        patch.data_ptr(), vi.data_ptr(), ui.data_ptr(), out.data_ptr(),
        TP, PS, V, stream)
    _build.check(err, "patch_lookup")
    _build.count_launch("patch_lookup")
    return out
