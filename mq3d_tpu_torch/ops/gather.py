"""K3: gather from a flat float32 table, out[i] = table[idx[i]].

Counterpart of the three Pallas kernels of tools/probe_pallas_gather.py
(`try_take`, `try_index2d`, `try_grid`), which probed whether the TPU
compiler can gather from a table held in VMEM.  On the card the three
table layouts are one function, run by `mq3d_tpu_torch.tools.probe_gather`.

`gather` launches the hand-written CUDA kernel (csrc/gather.cu) for
tensors on the card and runs `gather_plain` (torch.take) for tensors on
the CPU; anything else raises.  Indices must lie in [0, table.numel()):
torch.take rejects others, and the kernel reads NaN for them, as
jnp.take's default fill mode does.
"""

from __future__ import annotations

import torch

from mq3d_tpu_torch.kernels import _build


def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (n,) f32 table, (m,) i32 indices -> (m,) f32."""
    return torch.take(table, idx.long())


def _check(table, idx):
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(
            f"gather takes a float32 table and int32 indices, got {table.dtype}, "
            f"{idx.dtype}")
    if table.ndim != 1 or idx.ndim != 1:
        raise ValueError(
            f"gather takes a flat table and flat indices, got "
            f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.device != idx.device:
        raise ValueError("table and indices must lie on one device")


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]: (n,) f32, (m,) i32 -> (m,) f32.

    CUDA tensors launch K3; CPU tensors take the plain version."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {table.device}")
    if table.numel() >= 2 ** 31:
        raise ValueError(f"gather: table too large ({table.numel()} elements)")
    table = table.contiguous()
    idx = idx.contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    if out.numel() == 0:  # nothing to launch
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.mq3d_gather(table.data_ptr(), table.numel(), idx.data_ptr(),
                          out.data_ptr(), idx.numel(), stream)
    _build.check(err, "gather")
    _build.count_launch("gather")
    return out
