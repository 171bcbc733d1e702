"""Time an older build of the K1/K2 sources against the current one, in turns.

    git show <rev>:mq3d_tpu_torch/csrc/patch_lookup.cu > <dir>/patch_lookup.cu
    git show <rev>:mq3d_tpu_torch/csrc/i420.cu > <dir>/i420.cu
    python -m mq3d_tpu_torch.tools.kernel_ab --old-csrc <dir> [--json <file>]

Builds <dir>/*.cu into a second library (its C entry points take the same
arguments as the current ones) and times both on the same inputs, in the
order old, new, new, old, each a median of 20 cold-L2 launches
(utils/devtime.py).  Both outputs must equal the plain version.  K1 runs
at the integration tile's shapes (TP=512, PS=64, V=4096, random indices),
K2 at the main path's batch (16 frames of 960x1280).  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup_plain
from mq3d_tpu_torch.ops.yuv import yuv420_to_8uc3
from mq3d_tpu_torch.utils.devtime import bound_ms, time_ms

_ENTRY_POINTS = ("mq3d_patch_lookup", "mq3d_i420_to_bgr")


def load_old(csrc: Path):
    lib_path = _build.BUILD_DIR / "kernel_ab" / "libmq3d_kernels_old.so"
    report = _build.compile_library(sorted(csrc.glob("*.cu")), lib_path)
    print(f"[build] old sources {sorted(p.name for p in csrc.glob('*.cu'))}\n{report}",
          flush=True)
    return _build.load(lib_path, _ENTRY_POINTS)


def in_turns(old, new) -> dict:
    """old, new, new, old: four medians and the mean of each pair."""
    t = [time_ms(old), time_ms(new), time_ms(new), time_ms(old)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
            "old_mean_ms": (t[0] + t[3]) / 2, "new_mean_ms": (t[1] + t[2]) / 2}


def _ab(entry, old_lib, new_lib, args, out, ref, nbytes, ops) -> dict:
    """Check both libraries' `entry` against `ref`, then time them in turns."""
    stream = torch.cuda.current_stream().cuda_stream
    calls = {name: (lambda lib=lib: _build.check(
        getattr(lib, entry)(*args, stream), f"{name} {entry}"))
        for name, lib in (("old", old_lib), ("new", new_lib))}
    res = {}
    for name, fn in calls.items():
        out.zero_()
        fn()
        torch.cuda.synchronize()
        res[f"{name}_equal"] = bool(torch.equal(out, ref))
    res.update(in_turns(calls["old"], calls["new"]))
    res["bound_ms"], _ = bound_ms(nbytes, ops)
    res["bytes"] = nbytes
    return res


def k1(old_lib, new_lib, rng) -> dict:
    TP, PS, V = 512, 64, 4096
    patch = torch.from_numpy(rng.random((TP, PS, PS), dtype=np.float32)).cuda()
    vi = torch.from_numpy(rng.integers(-8, PS + 8, (TP, V), dtype=np.int32)).cuda()
    ui = torch.from_numpy(rng.integers(-8, PS + 8, (TP, V), dtype=np.int32)).cuda()
    out = torch.empty((TP, V), dtype=torch.float32, device="cuda")
    args = (patch.data_ptr(), vi.data_ptr(), ui.data_ptr(), out.data_ptr(), TP, PS, V)
    nbytes = patch.numel() * 4 + 2 * vi.numel() * 4 + out.numel() * 4
    res = _ab("mq3d_patch_lookup", old_lib, new_lib, args, out,
              patch_lookup_plain(patch, vi, ui), nbytes, 6 * TP * V)
    return {"shape": [TP, PS, V], **res}


def k2(old_lib, new_lib, rng) -> dict:
    N, H, W = 16, 960, 1280
    y = torch.from_numpy(rng.integers(0, 256, (N, H, W), dtype=np.uint8)).cuda()
    u = torch.from_numpy(rng.integers(0, 256, (N, H // 2, W // 2), dtype=np.uint8)).cuda()
    v = torch.from_numpy(rng.integers(0, 256, (N, H // 2, W // 2), dtype=np.uint8)).cuda()
    out = torch.empty((N, H, W, 3), dtype=torch.uint8, device="cuda")
    args = (y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), N, H, W)
    res = _ab("mq3d_i420_to_bgr", old_lib, new_lib, args, out,
              yuv420_to_8uc3(y, u, v), 4.5 * y.numel(), 20 * y.numel())
    return {"shape": [N, H, W], **res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", type=Path, required=True)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi}", flush=True)
    _build.build(force=True)
    print(f"[build] current sources\n{_build.last_build_report()}", flush=True)
    new_lib = _build.library()
    old_lib = load_old(args.old_csrc)
    rng = np.random.default_rng(0)
    result = {"device": smi, "k1": k1(old_lib, new_lib, rng),
              "k2": k2(old_lib, new_lib, rng)}
    for name in ("k1", "k2"):
        r = result[name]
        print(f"[{name}] {r['shape']}: old {r['old_ms']} ms, new {r['new_ms']} ms "
              f"(old, new, new, old); mean old {r['old_mean_ms']:.4f} new "
              f"{r['new_mean_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms; new at "
              f"{r['bytes'] / r['new_mean_ms'] / 1e6:.0f} GB/s; equal old "
              f"{r['old_equal']} new {r['new_equal']}", flush=True)
    line = json.dumps(result)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    print(line)
    ok = all(result[k][f"{w}_equal"] for k in ("k1", "k2") for w in ("old", "new"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
