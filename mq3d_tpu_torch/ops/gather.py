"""K3: gather from a flat float32 table, out[i] = table[idx[i]].

Counterpart of the three Pallas kernels of tools/probe_pallas_gather.py
(`try_take`, `try_index2d`, `try_grid`), which probed whether the TPU
compiler can gather from a table held in VMEM.  On the card the three
table layouts are one function, run by `mq3d_tpu_torch.tools.probe_gather`.

Indices outside [0, n) follow the TPU kernels, index by index:
  * "fill" (`gather_take_kernel`, `gather_grid_kernel`: jnp.take): an index
    in [-n, 0) reads table[n + i]; every other out-of-range index reads
    NaN.
  * "clip" (`gather2d_kernel`: x.reshape(-1)[i]): an index in [-n, 0)
    wraps the same way; the rest clamp to [0, n-1].

`gather` launches the hand-written CUDA kernel (csrc/gather.cu) for
tensors on the card and runs `gather_plain` for tensors on the CPU;
anything else raises.
"""

from __future__ import annotations

import torch

from mq3d_tpu_torch.kernels import _build

MODES = {"fill": 0, "clip": 1}


def resolve(idx: torch.Tensor, n: int, mode: str = "fill"):
    """(position in the table as int64, whether the index reads the table):
    the wrap of [-n, 0), then `mode`'s rule for the rest."""
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    if mode == "clip":
        i = i.clamp(0, n - 1)
    return i, (i >= 0) & (i < n)


def gather_plain(table: torch.Tensor, idx: torch.Tensor, mode: str = "fill") -> torch.Tensor:
    """Plain PyTorch version: (n,) f32 table, (m,) i32 indices -> (m,) f32.
    Never raises on an out-of-range index."""
    i, ok = resolve(idx, table.numel(), mode)
    nan = torch.full(idx.shape, float("nan"), dtype=table.dtype, device=table.device)
    if table.numel() == 0:
        return nan
    return torch.where(ok, table[torch.where(ok, i, 0)], nan)


def _check(table, idx, mode):
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
    if mode not in MODES:
        raise ValueError(f"gather: mode must be one of {sorted(MODES)}, got {mode!r}")
    if mode == "clip" and table.numel() == 0 and idx.numel() > 0:
        raise ValueError("gather: clip mode needs a table with an element")


def gather(table: torch.Tensor, idx: torch.Tensor, mode: str = "fill") -> torch.Tensor:
    """out[i] = table[idx[i]]: (n,) f32, (m,) i32 -> (m,) f32, with `mode`'s
    rule for out-of-range indices.

    CUDA tensors launch K3; CPU tensors take the plain version."""
    _check(table, idx, mode)
    if table.device.type == "cpu":
        return gather_plain(table, idx, mode)
    if table.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {table.device}")
    if table.numel() >= 2 ** 31:
        raise ValueError(f"gather: table too large ({table.numel()} elements)")
    table = table.contiguous()
    idx = idx.contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    if out.numel() == 0:  # nothing to launch
        return out
    _build.launch("gather", table.device, table.data_ptr(), table.numel(), idx.data_ptr(),
                  out.data_ptr(), idx.numel(), MODES[mode])
    return out
