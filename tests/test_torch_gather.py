"""mq3d_tpu_torch K3 (ops/gather.py) against the gather probe's three
Pallas kernels themselves.

tools/probe_pallas_gather.py is loaded by path and its kernels run through
`pl.pallas_call(..., interpret=True)` with the probe's own BlockSpecs
(whole arrays in VMEM; for `gather_grid_kernel` a grid of 256-index
blocks).  `gather` on the CPU runs the plain version; in "fill" mode it
must equal `gather_take_kernel` (K3a) and `gather_grid_kernel` (K3c), in
"clip" mode `gather2d_kernel` (K3b).  Tolerance: exact, bit for bit, NaN
bits included.  The CUDA kernel is held against the plain version on the
card by tests/test_torch_cuda.py.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mq3d_tpu_torch.ops.gather import gather, gather_plain
from mq3d_tpu_torch.tools import probe_gather

torch.set_num_threads(1)

_PROBE_PATH = Path(__file__).resolve().parent.parent / "tools" / "probe_pallas_gather.py"
_spec = importlib.util.spec_from_file_location("probe_pallas_gather", _PROBE_PATH)
_probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_probe)

GRID_BLOCK = 256
# call -> (mode of the port, Pallas kernel)
KERNELS = [("take", "fill"), ("index2d", "clip"), ("grid", "fill")]


def _pallas(call: str, table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The probe's Pallas kernel for `call`, in interpret mode."""
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    out_shape = jax.ShapeDtypeStruct(idx.shape, jnp.float32)
    tab, ix = jnp.asarray(table), jnp.asarray(idx)
    if call == "take":
        fn = pl.pallas_call(_probe.gather_take_kernel, out_shape=out_shape,
                            in_specs=[vmem, vmem], out_specs=vmem, interpret=True)
    elif call == "index2d":
        tab = tab.reshape(-1, 128)
        fn = pl.pallas_call(_probe.gather2d_kernel, out_shape=out_shape,
                            in_specs=[vmem, vmem], out_specs=vmem, interpret=True)
    else:
        n, m = table.size, idx.size
        fn = pl.pallas_call(
            _probe.gather_grid_kernel, out_shape=out_shape, grid=(m // GRID_BLOCK,),
            in_specs=[
                pl.BlockSpec((n,), lambda i: (0,), memory_space=pltpu.VMEM),
                pl.BlockSpec((GRID_BLOCK,), lambda i: (i,), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((GRID_BLOCK,), lambda i: (i,), memory_space=pltpu.VMEM),
            interpret=True)
    return np.asarray(fn(tab, ix))


def _check(call, mode, table, idx):
    want = _pallas(call, table.numpy(), idx.numpy())
    for got in (gather(table, idx, mode), gather_plain(table, idx, mode)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    return want


def _edge_indices(n: int, m: int, seed: int) -> torch.Tensor:
    """probe_gather.edges(n) (-1, -n, -n-1, n-1, n, n+7, INT32 min and max),
    then uniform in-range indices up to m."""
    edges = np.array(probe_gather.edges(n), np.int64)
    rest = np.random.default_rng(seed).integers(0, n, m - edges.size)
    return torch.from_numpy(np.concatenate([edges, rest]).astype(np.int32))


@pytest.mark.parametrize("call,mode", KERNELS)
@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
@pytest.mark.parametrize("m", [1024, 4096])
def test_gather_matches_pallas_in_range(call, mode, n, m):
    """Uniform in-range indices (the probe's make_inputs, smaller)."""
    table, idx = probe_gather.make_inputs(n, m, seed=n + m)
    _check(call, mode, table, idx)


@pytest.mark.parametrize("call,mode", KERNELS)
@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
def test_gather_matches_pallas_on_edges(call, mode, n):
    """Out-of-range indices: the wrap of [-n, 0), NaN (fill) or clamping
    (clip) past it, INT32 min and max; the plain version does not raise."""
    table, _ = probe_gather.make_inputs(n, 1, seed=n)
    want = _check(call, mode, table, _edge_indices(n, 1024, seed=n))
    nan = np.isnan(want[:8])
    assert list(nan) == ([False, False, True, False, True, True, True, True]
                         if mode == "fill" else [False] * 8)


def test_gather_rejects_unknown_modes_and_empty_clip_tables():
    with pytest.raises(ValueError):
        gather(torch.zeros(8), torch.zeros(4, dtype=torch.int32), "wrap")
    with pytest.raises(ValueError):
        gather(torch.zeros(0), torch.zeros(4, dtype=torch.int32), "clip")
    got = gather(torch.zeros(0), torch.tensor([0, -1, 5], dtype=torch.int32), "fill")
    assert torch.isnan(got).all()


def test_probe_makes_the_tpu_probes_calls():
    """probe_gather.CALLS are tools/probe_pallas_gather.py's `__main__`
    calls, in order, at the same table sizes, each with its kernel's mode."""
    main = _PROBE_PATH.read_text().split('if __name__ == "__main__":')[1]
    calls = [(name, (1 << int(shift)) * 4 // 2 ** 20) for name, shift in
             re.findall(r"try_(take|index2d|grid)\(1 << (\d+)\)", main)]
    assert calls == [(c, mb) for c, mb in probe_gather.CALLS]
    assert {c: probe_gather.KERNELS[c][1] for c, _ in probe_gather.CALLS} == dict(KERNELS)
