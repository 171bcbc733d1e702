"""How fast does the card gather from a table, by where the table lives?

    python -m mq3d_tpu_torch.tools.probe_gather [--sizes-mb 4 16 128] [--device cuda]

Counterpart of tools/probe_pallas_gather.py, which asked whether the TPU
compiler (Mosaic) can gather with a vector of runtime indices from a table
held in VMEM, in three layouts (whole, as (rows, 128), over a grid of index
blocks).  On the card the three layouts are one function, K3
(ops/gather.py, csrc/gather.cu), and the question becomes where the table
fits: under 227 KB it could be staged in one block's shared memory; under
the 50 MB L2 it is read from HBM once per touched sector and then hits in
L2; larger tables stream from HBM.

For each table size (the TPU probe's 4 to 128 MB, 2^19 indices, the same
numpy generator and seed) it gathers once with K3, checks the result
against torch.take, and on the card times K3 and torch.take from a cold L2
(utils/devtime.py).  One line per size, then one JSON line.  On the CPU
(--device cpu) it runs the plain version and times nothing.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.ops.gather import gather, gather_plain

N_IDX = 1 << 19
TABLE_MB = (4, 16, 32, 64, 128)
SHARED_BYTES = 232448        # 227 KB a block can use
L2_BYTES = 50 * 1024 * 1024  # H100


def make_inputs(table_elems: int, n_idx: int = N_IDX, seed: int = 0,
                device="cpu"):
    """The TPU probe's inputs: a uniform float32 table and uniform int32
    indices into it, from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    tab = rng.random(table_elems).astype(np.float32)
    idx = rng.integers(0, table_elems, n_idx).astype(np.int32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(idx).to(device)


def fits_in(table_bytes: int) -> str:
    """The nearest level of the card's memory that holds the whole table."""
    if table_bytes <= SHARED_BYTES:
        return "shared memory"
    return "L2" if table_bytes < L2_BYTES else "HBM"


def probe(table_elems: int, device, n_idx: int = N_IDX, seed: int = 0) -> dict:
    tab, idx = make_inputs(table_elems, n_idx, seed, device)
    out = gather(tab, idx)
    equal = bool(torch.equal(out, gather_plain(tab, idx)))
    row = {"table_mb": table_elems * 4 / 2 ** 20, "indices": n_idx,
           "fits_in": fits_in(table_elems * 4), "equal": equal}
    if device.type == "cuda":
        from mq3d_tpu_torch.utils.devtime import time_ms

        idx64 = idx.long()
        row["ms"] = time_ms(lambda: gather(tab, idx))
        row["torch_take_ms"] = time_ms(lambda: torch.take(tab, idx64))
        # Bytes a random gather really moves: a 32-byte sector per index.
        row["sector_gb_per_s"] = n_idx * (4 + 4 + 32) / row["ms"] / 1e6
    return row


def run(sizes_mb=TABLE_MB, device="cuda") -> list:
    dev = resolve_device(device)
    rows = []
    for mb in sizes_mb:
        t0 = time.perf_counter()
        row = probe(int(mb * 2 ** 20) // 4, dev)
        rows.append(row)
        timing = (f"K3 {row['ms']:.4f} ms, torch.take {row['torch_take_ms']:.4f} ms, "
                  f"{row['sector_gb_per_s']:.0f} GB/s in 32-byte sectors"
                  if "ms" in row else "not timed (CPU)")
        print(f"[{'ok' if row['equal'] else 'FAIL'}] {mb:g} MB table "
              f"(fits {row['fits_in']}), {N_IDX} indices: {timing} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes-mb", type=float, nargs="+", default=list(TABLE_MB))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.sizes_mb, args.device)
    print(json.dumps({"probe_gather": rows}))
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
