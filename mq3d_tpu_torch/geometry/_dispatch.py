"""Array-namespace dispatch: numpy on host arrays, torch on tensors.

Geometry primitives serve both tiny host-side pose tables (numpy) and
tensors on the card.  Every function in geometry/ picks its namespace from
its inputs, so one implementation serves both; the torch namespace below
adapts the handful of numpy spellings those functions use.
"""

from __future__ import annotations

import numpy as np
import torch


class _TorchNamespace:
    """The numpy-style calls of geometry/ expressed with torch, creating new
    tensors on the device of the inputs."""

    float32 = torch.float32
    float64 = torch.float64
    linalg = torch.linalg

    def __init__(self, device: torch.device):
        self.device = device

    def asarray(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def eye(self, n, dtype=None):
        return torch.eye(n, dtype=dtype, device=self.device)

    @staticmethod
    def concatenate(xs, axis=0):
        return torch.cat(list(xs), dim=axis)

    @staticmethod
    def stack(xs, axis=0):
        return torch.stack(list(xs), dim=axis)

    @staticmethod
    def cross(a, b):
        a, b = torch.broadcast_tensors(a, b)
        return torch.linalg.cross(a, b, dim=-1)

    @staticmethod
    def where(c, a, b):
        ref = next((t for t in (a, b, c) if isinstance(t, torch.Tensor)), None)
        a = torch.as_tensor(a, dtype=ref.dtype if isinstance(a, float) else None,
                            device=ref.device)
        b = torch.as_tensor(b, dtype=ref.dtype if isinstance(b, float) else None,
                            device=ref.device)
        return torch.where(torch.as_tensor(c, device=ref.device), a, b)

    @staticmethod
    def sum(x, axis=None, keepdims=False):
        return x.sum(dim=axis, keepdim=keepdims)

    @staticmethod
    def argmax(x, axis=None):
        return torch.argmax(x, dim=axis)

    @staticmethod
    def take_along_axis(x, idx, axis):
        idx = idx.expand(*x.shape[:axis] if axis >= 0 else x.shape[:x.ndim + axis],
                         idx.shape[axis], *x.shape[axis + 1:] if axis != -1 else ())
        return torch.gather(x, axis, idx)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def swapaxes(x, a, b):
        return x.transpose(a, b)

    @staticmethod
    def broadcast_to(x, shape):
        return x.expand(shape)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def ones_like(x):
        return torch.ones_like(x)

    abs = staticmethod(torch.abs)
    sqrt = staticmethod(torch.sqrt)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    arccos = staticmethod(torch.arccos)

    @staticmethod
    def maximum(a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, min=b)
        return torch.maximum(a, b)
    isinf = staticmethod(torch.isinf)


def get_namespace(*arrays):
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return _TorchNamespace(a.device)
    return np
