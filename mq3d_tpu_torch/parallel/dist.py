"""Process groups, ranks and the collectives of the sharded paths.

The JAX package's multi-device paths are one SPMD program over a
`jax.sharding.Mesh` (`shard_map`, `psum`, `all_gather`).  Here every rank
is a process, and a `torch.distributed` process group takes the mesh's
place: NCCL between cards, gloo on the CPU and for several ranks that
share one card (NCCL refuses two ranks on one GPU).  The caller always
names the backend; nothing here picks one.

`spawn_ranks` starts the ranks of one host with the `spawn` start method
(CUDA forbids fork) over a `file://` store in a fresh temporary directory,
so concurrent worlds (parallel test workers) never share a port, and joins
them with a deadline: when a rank fails or the deadline passes, the others
are killed (they would wait in a collective) and it raises.

Collectives on a gloo group stage CUDA tensors through host memory: gloo's
support of CUDA tensors differs between collectives and releases, and its
own CUDA path copies through pinned host memory anyway.  That is the gloo
backend's path, not a fallback: an NCCL group runs every collective on the
card.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def init_group(backend: str, rank: Optional[int] = None, world: Optional[int] = None,
               init_method: Optional[str] = None, timeout_s: float = 1800.0):
    """Initialise the default process group and return it.

    Either `rank`, `world` and `init_method` are all given, or none is and
    torchrun's environment names them (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT; init method ``env://``).  An NCCL rank binds to card
    LOCAL_RANK (torchrun) or rank % device count before the group forms.
    Collectives wait at most `timeout_s` seconds."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {BACKENDS}")
    given = [x is not None for x in (rank, world, init_method)]
    if any(given) and not all(given):
        raise ValueError("pass rank, world and init_method together, or none of "
                         "them to read torchrun's environment")
    if not any(given):
        rank, world, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=int(rank),
                            world_size=int(world),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def world_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """True where a collective takes a host copy of `t` (gloo, CUDA tensor)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of `t` over `group` ("sum" or "max")."""
    red = _REDUCE_OPS[op]
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, red, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, red, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated along dim 0 in rank
    order, on `t`'s device."""
    src = t.cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(world_of(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def sum_scalar(x: int, group) -> int:
    """Sum of a Python int over the group (on the host for gloo, on the
    rank's card for NCCL)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor([x], dtype=torch.int64, device=dev)
    dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
    return int(t.item())


def rank_slice(n: int, group) -> slice:
    """The contiguous block of n items that this rank owns (n divisible by
    the world size), as `PartitionSpec(axis)` gives each device."""
    world = world_of(group)
    if n % world:
        raise ValueError(f"{n} items do not divide over {world} ranks")
    per = n // world
    r = rank_of(group)
    return slice(r * per, (r + 1) * per)


def _resolve(qualname: str):
    module, _, name = qualname.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(qualname, rank, world, backend, device, init_method, payload,
               out_dir, timeout_s):
    """Body of one spawned rank: join the group, run the function, write
    ("ok", result) or ("error", traceback) to out_dir/rank<r>.pkl."""
    out = Path(out_dir) / f"rank{rank}.pkl"
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        group = init_group(backend, rank, world, init_method, timeout_s)
        try:
            result = ("ok", _resolve(qualname)(group, dev, payload))
        finally:
            destroy_group()
    except BaseException:  # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    if result[0] == "error":
        raise SystemExit(1)


def spawn_ranks(fn_qualname: str, world: int, backend: str, device: str,
                payload: Any = None, *, timeout_s: float) -> List[Any]:
    """Run `fn(group, device, payload)` on `world` fresh processes of this
    host and return their results in rank order.

    `fn_qualname` is "package.module:function"; the function, the payload
    and the results must pickle.  Rank r runs on `device` ("cpu", or
    "cuda" -> card r % device count).  Raises RuntimeError with the
    failing ranks' tracebacks when a rank fails, TimeoutError when the
    ranks have not all ended `timeout_s` seconds after the start; the
    surviving ranks are killed either way."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {BACKENDS}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mq3d_ranks_") as tmp:
        init_method = f"file://{tmp}/store"
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(fn_qualname, r, world, backend, device, init_method,
                                   payload, tmp, timeout_s))
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while any(p.exitcode is None for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{fn_qualname} on {world} {backend} ranks did not end within "
                        f"{timeout_s} s")
                procs[0].join(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"rank{r}.pkl"
            if path.exists():
                with open(path, "rb") as f:
                    status, value = pickle.load(f)
            else:
                status, value = "error", f"exit code {p.exitcode}, no result"
            if status == "ok":
                results.append(value)
            else:
                errors.append(f"rank {r}: {value}")
        if errors:
            raise RuntimeError(f"{fn_qualname} failed on {world} {backend} ranks:\n"
                               + "\n".join(errors))
        return results
