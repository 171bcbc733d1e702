"""Batch of capture sessions sharded over hosts.

Counterpart of mq3d_tpu/parallel/multihost.py.  Sessions are independent
(the reference runs them one subprocess after another,
scripts/batch_run_full_pipeline.py:28-230), so each host runs its share of
them, each session through the port's run_full_pipeline CLI in its own
subprocess (a crash marks that session failed and the batch goes on), and
only two things cross hosts:

  * the assignment, a pure function of (n_sessions, n_hosts, host_id), so
    no coordinator is needed;
  * the end-of-batch status roll-up, one all-gather of an int32 vector over
    a gloo process group (host bytes; parallel/dist.py).

Host topology: explicit (host_id, n_hosts), else a live torch.distributed
group (rank, world size), else a single host.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mq3d_tpu_torch.parallel.dist import all_gather, spawn_ranks

_STATUS_NOT_MINE = -1  # session assigned to another host
_STATUS_FAILED = 0
_STATUS_OK = 1


def resolve_host_topology(host_id: Optional[int] = None,
                          n_hosts: Optional[int] = None) -> Tuple[int, int]:
    """(host_id, n_hosts) from explicit args, else the live process group,
    else (0, 1)."""
    if host_id is not None or n_hosts is not None:
        hid, n = int(host_id or 0), int(n_hosts or 1)
        # A lone --host-id would make this host skip sessions that no other
        # host runs (assign_sessions strides by n_hosts=1 starting at hid)
        # and still report success: reject it instead.
        if not 0 <= hid < n:
            raise ValueError(
                f"host_id={hid} out of range for n_hosts={n}; pass both "
                "--host-id and --n-hosts with 0 <= host_id < n_hosts")
        return hid, n
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def assign_sessions(n_sessions: int, n_hosts: int, host_id: int) -> List[int]:
    """Strided round-robin: session i -> host i % n_hosts.  The same on
    every host with no communication, and balanced when session costs are
    i.i.d. (consecutive captures correlate in length, so striding beats
    contiguous blocks)."""
    return list(range(host_id, n_sessions, n_hosts))


def _default_runner(session: Path, config: Optional[Path], reuse_cache: bool = False,
                    device: str = "cuda") -> bool:
    """One session through the port's run_full_pipeline CLI in its own
    subprocess (failure isolation, as in the single-host batch CLI)."""
    cmd = [sys.executable, "-u", "-m", "mq3d_tpu_torch.scripts.run_full_pipeline",
           "--session_dir", str(session)]
    if config is not None:
        cmd += ["--config", str(config)]
    if not reuse_cache:
        cmd.append("--no-cache")
    cmd += ["--device", device]
    # The package's root on the child's path, whether or not it is installed.
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.time()
    result = subprocess.run(cmd, env=env)
    print(f"[Info] Session {Path(session).name} finished in "
          f"{time.time() - t0:.1f}s (exit {result.returncode})", flush=True)
    return result.returncode == 0


def rollup_statuses(local_status: np.ndarray, n_hosts: int) -> np.ndarray:
    """Merge the hosts' (n_sessions,) status vectors into the global one.

    Each host fills only its own sessions (the others are
    _STATUS_NOT_MINE), so the merge is an elementwise max of the
    all-gathered vectors, over the live process group when it has n_hosts
    ranks; otherwise the local vector is returned."""
    if n_hosts <= 1:
        return local_status
    if dist.is_initialized() and dist.get_world_size() == n_hosts:
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        local = torch.from_numpy(np.ascontiguousarray(local_status, np.int32)).to(dev)
        gathered = all_gather(local[None], dist.group.WORLD)  # (n_hosts, n_sessions)
        return gathered.max(dim=0).values.cpu().numpy()
    why = ("no process group is live" if not dist.is_initialized()
           else f"the process group has {dist.get_world_size()} ranks")
    print(f"[Warning] DCN roll-up unavailable ({why}); "
          "statuses cover the local shard only")
    return local_status


def batch_sessions_multihost(session_dirs: Sequence[Path], config: Optional[Path] = None,
                             host_id: Optional[int] = None, n_hosts: Optional[int] = None,
                             reuse_cache: bool = False,
                             runner: Optional[Callable[[Path], bool]] = None,
                             device: str = "cuda") -> np.ndarray:
    """Run this host's share of a batch of sessions; returns the merged
    (n_sessions,) status vector (1 ok, 0 failed, -1 another host's and not
    known here) and prints it with the failure roll-up."""
    host_id, n_hosts = resolve_host_topology(host_id, n_hosts)
    session_dirs = [Path(s) for s in session_dirs]
    mine = assign_sessions(len(session_dirs), n_hosts, host_id)
    print(f"[Info] Host {host_id}/{n_hosts}: {len(mine)} of "
          f"{len(session_dirs)} session(s) assigned", flush=True)

    run = runner if runner is not None else (
        lambda s: _default_runner(s, config, reuse_cache, device))
    status = np.full(len(session_dirs), _STATUS_NOT_MINE, np.int32)
    for i in mine:
        ok = False
        try:
            ok = bool(run(session_dirs[i]))
        except Exception as e:  # noqa: BLE001 - per-session isolation
            print(f"[Warning] Session {session_dirs[i].name} raised: {e}")
        status[i] = _STATUS_OK if ok else _STATUS_FAILED

    status = rollup_statuses(status, n_hosts)
    failed = [session_dirs[i].name for i in np.nonzero(status == 0)[0]]
    n_known = int((status >= 0).sum())
    print(f"[Info] Batch complete: {int((status == 1).sum())}/{n_known} "
          f"session(s) succeeded; status {status.tolist()}", flush=True)
    if failed:
        print("[Warning] Failed sessions:")
        for name in failed:
            print(f"  - {name}")
    return status


def _rank_batch_dryrun(group, device, n_sessions: int) -> np.ndarray:
    """One host of dryrun_batch_multihost: fill its strided share with
    session 1 failing, then roll the statuses up over the group."""
    hid, n_hosts = dist.get_rank(group), dist.get_world_size(group)
    sess = np.arange(n_sessions)
    ok = np.where(sess == 1, _STATUS_FAILED, _STATUS_OK)
    local = np.where(sess % n_hosts == hid, ok, _STATUS_NOT_MINE).astype(np.int32)
    return rollup_statuses(local, n_hosts)


def dryrun_batch_multihost(n_hosts: int, n_sessions: int = 7,
                           timeout_s: float = 120.0) -> np.ndarray:
    """The multi-host roll-up on n_hosts gloo ranks of this machine
    (processes standing in for hosts), the JAX package's dryrun on a
    virtual mesh: each rank fills its strided share with session 1
    failing, the vectors merge with all-gather + max, and every rank must
    see the same global vector.  Returns it."""
    out = np.stack(spawn_ranks("mq3d_tpu_torch.parallel.multihost:_rank_batch_dryrun",
                               n_hosts, "gloo", "cpu", n_sessions, timeout_s=timeout_s))
    expect = np.full(n_sessions, _STATUS_OK, np.int32)
    expect[1] = _STATUS_FAILED
    for h in range(n_hosts):
        np.testing.assert_array_equal(out[h], expect)
    print(f"[dryrun_batch_multihost] ok: {n_sessions} sessions over "
          f"{n_hosts} hosts, failure roll-up merged on every host")
    return out[0]
