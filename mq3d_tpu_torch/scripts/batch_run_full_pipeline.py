"""CLI: the full pipeline over many capture sessions, optionally sharded
over hosts.

    python -m mq3d_tpu_torch.scripts.batch_run_full_pipeline \
        --base-dirs <dir> [<dir> ...] [--config <yml>] [--reuse-cache] \
        [--dry-run] [--n-hosts N --host-id I [--init-method URL]] [--device cpu]

Counterpart of scripts/batch_run_full_pipeline.py of the JAX build
(reference: scripts/batch_run_full_pipeline.py:28-230): discovers the
session directories (named YYYYMMDD_HHMMSS) under the base dirs and runs
each through the port's run_full_pipeline CLI in its own subprocess
(parallel/multihost.py), then prints the failure roll-up and the status
vector; exits 1 when any session failed.

With --n-hosts and --host-id this host runs sessions host_id,
host_id + n_hosts, ...  The hosts' statuses merge over a gloo process
group when one is joined: --init-method (e.g. tcp://<host 0>:<port> or
file:///<shared dir>/store), or torchrun's environment (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT).  Without a group each host reports its own
sessions only.
"""

from __future__ import annotations

import argparse
import os
import re
from pathlib import Path

from mq3d_tpu_torch.scripts._cli import DEFAULT_CONFIG, add_device

SESSION_RE = re.compile(r"^\d{8}_\d{6}$")
# The roll-up waits at the all-gather for the slowest host's sessions.
ROLLUP_TIMEOUT_S = 24 * 3600


def discover_project_dirs(base_dirs):
    sessions = []
    for base in base_dirs:
        base = Path(base)
        if not base.is_dir():
            print(f"[Warning] Base dir does not exist: {base}")
            continue
        for d in sorted(base.iterdir()):
            if d.is_dir() and SESSION_RE.match(d.name):
                sessions.append(d)
    return sessions


def main(argv=None) -> int:
    from mq3d_tpu_torch.parallel.dist import destroy_group, init_group
    from mq3d_tpu_torch.parallel.multihost import batch_sessions_multihost

    parser = argparse.ArgumentParser(description="Batch-run the full pipeline")
    parser.add_argument("--base-dirs", type=Path, nargs="+", required=True)
    parser.add_argument("--config", type=Path, default=DEFAULT_CONFIG)
    parser.add_argument("--reuse-cache", action="store_true")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--n-hosts", type=int, default=None,
                        help="shard the session batch over this many hosts; default: "
                             "the joined process group's size, else one host")
    parser.add_argument("--host-id", type=int, default=None,
                        help="this host's index in [0, n_hosts)")
    parser.add_argument("--init-method", default=None,
                        help="join a gloo process group of n_hosts ranks at this URL "
                             "for the status roll-up (default: torchrun's environment "
                             "when set)")
    add_device(parser)
    args = parser.parse_args(argv)

    sessions = discover_project_dirs(args.base_dirs)
    print(f"[Info] Discovered {len(sessions)} session(s).", flush=True)
    if args.dry_run:
        for s in sessions:
            print(f"  would run: {s}")
        return 0

    if args.init_method is not None:
        if args.n_hosts is None or args.host_id is None:
            parser.error("--init-method needs --n-hosts and --host-id")
        init_group("gloo", args.host_id, args.n_hosts, args.init_method, ROLLUP_TIMEOUT_S)
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        init_group("gloo", timeout_s=ROLLUP_TIMEOUT_S)
    try:
        status = batch_sessions_multihost(
            sessions, config=args.config, host_id=args.host_id, n_hosts=args.n_hosts,
            reuse_cache=args.reuse_cache, device=args.device)
    finally:
        destroy_group()
    return 1 if (status == 0).any() else 0


if __name__ == "__main__":
    raise SystemExit(main())
