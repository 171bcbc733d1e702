"""How fast does the card gather from a table, by where the table lives?

    python -m mq3d_tpu_torch.tools.probe_gather [--sizes-mb 4 16 128] [--device cuda]

Counterpart of tools/probe_pallas_gather.py, which asked whether the TPU
compiler (Mosaic) can gather with a vector of runtime indices from a table
held in VMEM, in three layouts: whole (`try_take`, K3a, jnp.take), as
(rows, 128) flattened (`try_index2d`, K3b, x.reshape(-1)[i]) and over a
grid of index blocks (`try_grid`, K3c).  On the card the three layouts are
one function, K3 (ops/gather.py, csrc/gather.cu), in the TPU kernels' two
out-of-range modes ("fill" for K3a and K3c, "clip" for K3b), and the
question becomes where the table fits: up to 227 KB in one block's shared
memory; under the 50 MB L2 it is read from HBM once per touched sector and
then hits in L2; larger tables stream from HBM.

It makes the TPU probe's seven calls in its order (CALLS: take at 4 and 16
MB, index2d and grid at 4 MB, take at 32, 64 and 128 MB; 2^19 indices, the
same numpy generator and seed), or `take` at each of --sizes-mb.  Each call
gathers once with K3 and checks the result against the plain version bit
for bit; on the card it also times K3, the plain version and torch.take
from a cold L2 (utils/devtime.py) beside two bounds: the bytes the call
must move (indices and outputs once, each distinct table element once) and
the 32-byte sectors it must fetch (each distinct sector once), both over
the HBM rate.  One line per call, then one JSON line.  On the CPU (--device
cpu) it runs the plain version and times nothing.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.ops.gather import gather, gather_plain, resolve

N_IDX = 1 << 19
TABLE_MB = (4, 16, 32, 64, 128)
# The TPU probe's calls (tools/probe_pallas_gather.py `__main__`), in order.
CALLS = (("take", 4), ("take", 16), ("index2d", 4), ("grid", 4),
         ("take", 32), ("take", 64), ("take", 128))
# call -> (TPU kernel, out-of-range mode)
KERNELS = {"take": ("K3a", "fill"), "index2d": ("K3b", "clip"), "grid": ("K3c", "fill")}
SHARED_BYTES = 232448        # 227 KB a block can use
L2_BYTES = 50 * 1024 * 1024  # H100
SECTOR = 32                  # bytes the card fetches for a random draw


def make_inputs(table_elems: int, n_idx: int = N_IDX, seed: int = 0,
                device="cpu"):
    """The TPU probe's inputs: a uniform float32 table and uniform int32
    indices into it, from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    tab = rng.random(table_elems).astype(np.float32)
    idx = rng.integers(0, table_elems, n_idx).astype(np.int32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(idx).to(device)


def edges(n: int) -> list:
    """The out-of-range cases of a table of n elements, and its ends:
    -1, -n, -n-1, n-1, n, n+7, INT32 min and max."""
    return [-1, -n, -n - 1, n - 1, n, n + 7, -2 ** 31, 2 ** 31 - 1]


def fits_in(table_bytes: int) -> str:
    """The nearest level of the card's memory that holds the whole table."""
    if table_bytes <= SHARED_BYTES:
        return "shared memory"
    return "L2" if table_bytes < L2_BYTES else "HBM"


def traffic(table: torch.Tensor, idx: torch.Tensor, mode: str = "fill") -> dict:
    """Bytes a gather of these indices must move: indices and outputs once,
    plus each distinct table element once ("bytes") or each distinct
    32-byte sector once ("sector_bytes"; the table starts on a sector)."""
    i, ok = resolve(idx, table.numel(), mode)
    read = i[ok]
    stream = idx.numel() * 8
    distinct = int(torch.unique(read).numel())
    sectors = int(torch.unique(read // (SECTOR // 4)).numel())
    return {"distinct": distinct, "bytes": stream + 4 * distinct,
            "sector_bytes": stream + SECTOR * sectors}


def equal_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality of two float32 tensors (NaN bits included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def probe(call: str, table_mb: float, device, n_idx: int = N_IDX, seed: int = 0) -> dict:
    kernel, mode = KERNELS[call]
    elems = int(table_mb * 2 ** 20) // 4
    tab, idx = make_inputs(elems, n_idx, seed, device)
    if call == "index2d":  # the TPU probe's (rows, 128) table, flattened
        tab = tab.view(-1, 128).reshape(-1)
    out = gather(tab, idx, mode)
    row = {"call": call, "kernel": kernel, "mode": mode, "table_mb": elems * 4 / 2 ** 20,
           "indices": n_idx, "fits_in": fits_in(elems * 4),
           "equal": equal_bits(out, gather_plain(tab, idx, mode))}
    if device.type == "cuda":
        from mq3d_tpu_torch.utils.devtime import bound_ms, time_ms

        idx64 = idx.long()
        row["ms"] = time_ms(lambda: gather(tab, idx, mode))
        row["plain_ms"] = time_ms(lambda: gather_plain(tab, idx, mode))
        row["torch_take_ms"] = time_ms(lambda: torch.take(tab, idx64))
        t = traffic(tab, idx, mode)
        row["bound_ms"] = bound_ms(t["bytes"], n_idx)[0]  # one resolve per index
        row["sector_bound_ms"] = bound_ms(t["sector_bytes"], n_idx)[0]
        row["sector_gb_per_s"] = t["sector_bytes"] / row["ms"] / 1e6
    return row


def run(calls=CALLS, device="cuda") -> list:
    dev = resolve_device(device)
    rows = []
    for call, mb in calls:
        t0 = time.perf_counter()
        row = probe(call, mb, dev)
        rows.append(row)
        timing = (f"K3 {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, torch.take "
                  f"{row['torch_take_ms']:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_ms'] / row['ms']:.0%}), "
                  f"sector bound {row['sector_bound_ms']:.4f} ms "
                  f"({row['sector_bound_ms'] / row['ms']:.0%}), "
                  f"{row['sector_gb_per_s']:.0f} GB/s in 32-byte sectors"
                  if "ms" in row else "not timed (CPU)")
        print(f"[{'ok' if row['equal'] else 'FAIL'}] {call} ({row['kernel']}, "
              f"{row['mode']}) {mb:g} MB table (fits {row['fits_in']}), {N_IDX} "
              f"indices: {timing} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes-mb", type=float, nargs="+", default=None,
                    help="take at these table sizes instead of the TPU probe's calls")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    calls = CALLS if args.sizes_mb is None else [("take", mb) for mb in args.sizes_mb]
    rows = run(calls, args.device)
    print(json.dumps({"probe_gather": rows}))
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
