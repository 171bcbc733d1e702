"""Time an older build of the kernel sources against the current one, in turns.

    mkdir -p build/old_csrc
    for f in patch_lookup.cu i420.cu gather.cu; do
        git show <rev>:mq3d_tpu_torch/csrc/$f > build/old_csrc/$f; done
    python -m mq3d_tpu_torch.tools.kernel_ab --old-csrc build/old_csrc \
        [--json <file>]

Builds <dir>/*.cu into a second library and times both on the same inputs,
in the order old, new, new, old, each a median of 20 cold-L2 launches
(utils/devtime.py).  Both outputs must equal the plain version bit for bit.
K1 runs at the integration tile's shapes (TP=512, PS=64, V=4096, random
indices), K2 at the main path's batch (16 frames of 960x1280), K3 at the
gather probe's tables (0.125 MB, the probe's CPU test size, then 4 to 128
MB; 2^19 uniform in-range indices, where the old and new kernels compute
the same thing) beside torch.take, the byte bound and the sector-counted
bound (tools/probe_gather.py `traffic`).  The old K1/K2 entry points take
the current arguments; an old gather.cu whose entry point has no `int
mode` argument (before the out-of-range modes) is called as (table, n, idx,
out, m, stream).  Then it times what a random draw costs in HBM
(`k3_granularity`) and prints the timer's floor (an empty launch under the
same timer).  Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops.gather import gather_plain
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup_plain
from mq3d_tpu_torch.ops.yuv import yuv420_to_8uc3
from mq3d_tpu_torch.tools import probe_gather
from mq3d_tpu_torch.utils.devtime import bound_ms, floor_ms, time_ms

_ENTRY_POINTS = ("mq3d_patch_lookup", "mq3d_i420_to_bgr", "mq3d_gather")
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The gather entry point before the out-of-range modes: no `mode` argument.
_GATHER_NO_MODE = (_P, _I, _P, _P, _LL, _P)
K3_TABLE_MB = (0.125,) + probe_gather.TABLE_MB


def has_modes(csrc: Path) -> bool:
    """Whether the old gather.cu's entry point takes the out-of-range mode."""
    text = (csrc / "gather.cu").read_text()
    return "int mode" in text[text.index('extern "C" int mq3d_gather('):]


def load_old(csrc: Path):
    lib_path = _build.BUILD_DIR / "kernel_ab" / "libmq3d_kernels_old.so"
    report = _build.compile_library(sorted(csrc.glob("*.cu")), lib_path)
    print(f"[build] old sources {sorted(p.name for p in csrc.glob('*.cu'))}\n{report}",
          flush=True)
    if has_modes(csrc):
        return _build.load(lib_path, _ENTRY_POINTS)
    lib = _build.load(lib_path, _ENTRY_POINTS[:2])
    lib.mq3d_gather.argtypes = list(_GATHER_NO_MODE)
    lib.mq3d_gather.restype = ctypes.c_int
    return lib


def in_turns(old, new) -> dict:
    """old, new, new, old: four medians and the mean of each pair."""
    t = [time_ms(old), time_ms(new), time_ms(new), time_ms(old)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
            "old_mean_ms": (t[0] + t[3]) / 2, "new_mean_ms": (t[1] + t[2]) / 2}


def _ab(calls, out, ref, nbytes, ops) -> dict:
    """Check the old and new calls against `ref` bit for bit, then time
    them in turns."""
    res = {}
    for name, fn in calls.items():
        out.zero_()
        fn()
        torch.cuda.synchronize()
        res[f"{name}_equal"] = probe_gather.equal_bits(out, ref) if out.dtype == torch.float32 \
            else bool(torch.equal(out, ref))
    res.update(in_turns(calls["old"], calls["new"]))
    res["bound_ms"], _ = bound_ms(nbytes, ops)
    res["bytes"] = nbytes
    return res


def _calls(entry, old_lib, new_lib, args, old_args=None) -> dict:
    stream = torch.cuda.current_stream().cuda_stream
    return {name: (lambda lib=lib, a=a: _build.check(
        getattr(lib, entry)(*a, stream), f"{name} {entry}"))
        for name, lib, a in (("old", old_lib, old_args or args), ("new", new_lib, args))}


def k1(old_lib, new_lib, rng) -> dict:
    TP, PS, V = 512, 64, 4096
    patch = torch.from_numpy(rng.random((TP, PS, PS), dtype=np.float32)).cuda()
    vi = torch.from_numpy(rng.integers(-8, PS + 8, (TP, V), dtype=np.int32)).cuda()
    ui = torch.from_numpy(rng.integers(-8, PS + 8, (TP, V), dtype=np.int32)).cuda()
    out = torch.empty((TP, V), dtype=torch.float32, device="cuda")
    args = (patch.data_ptr(), vi.data_ptr(), ui.data_ptr(), out.data_ptr(), TP, PS, V)
    nbytes = patch.numel() * 4 + 2 * vi.numel() * 4 + out.numel() * 4
    res = _ab(_calls("mq3d_patch_lookup", old_lib, new_lib, args), out,
              patch_lookup_plain(patch, vi, ui), nbytes, 6 * TP * V)
    return {"shape": [TP, PS, V], **res}


def k2(old_lib, new_lib, rng) -> dict:
    N, H, W = 16, 960, 1280
    y = torch.from_numpy(rng.integers(0, 256, (N, H, W), dtype=np.uint8)).cuda()
    u = torch.from_numpy(rng.integers(0, 256, (N, H // 2, W // 2), dtype=np.uint8)).cuda()
    v = torch.from_numpy(rng.integers(0, 256, (N, H // 2, W // 2), dtype=np.uint8)).cuda()
    out = torch.empty((N, H, W, 3), dtype=torch.uint8, device="cuda")
    args = (y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), N, H, W)
    res = _ab(_calls("mq3d_i420_to_bgr", old_lib, new_lib, args), out,
              yuv420_to_8uc3(y, u, v), 4.5 * y.numel(), 20 * y.numel())
    return {"shape": [N, H, W], **res}


def k3(old_lib, new_lib, old_modes: bool) -> list:
    rows = []
    for mb in K3_TABLE_MB:
        tab, idx = probe_gather.make_inputs(int(mb * 2 ** 20) // 4, device="cuda")
        n, m = tab.numel(), idx.numel()
        out = torch.empty(m, dtype=torch.float32, device="cuda")
        ptrs = (tab.data_ptr(), n, idx.data_ptr(), out.data_ptr(), m)
        new_args = ptrs + (0,)  # fill mode
        old_args = new_args if old_modes else ptrs
        ref = gather_plain(tab, idx)
        t = probe_gather.traffic(tab, idx)
        res = _ab(_calls("mq3d_gather", old_lib, new_lib, new_args, old_args), out, ref,
                  t["bytes"], m)
        idx64 = idx.long()
        res["torch_take_ms"] = time_ms(lambda: torch.take(tab, idx64))
        res["sector_bound_ms"], _ = bound_ms(t["sector_bytes"], m)
        res["sector_bytes"] = t["sector_bytes"]
        rows.append({"table_mb": mb, "indices": m, "fits_in": probe_gather.fits_in(n * 4),
                     **res})
    return rows


def k3_granularity(lib, rng) -> dict:
    """What a random draw costs in HBM.  At a 128 MB table, 2^19 draws, each
    in its own 32-byte sector, the sectors chosen as one per 64-byte
    segment, both sectors of 2^18 segments, or all four sectors of 2^17
    128-byte lines, in shuffled order, then the probe's uniform draws as
    they come and sorted; timed forward and backward.  If HBM served
    32-byte sectors at its byte rate, the first three would take the same
    time and sorting would change nothing."""
    n, m = 128 * 2 ** 20 // 4, 1 << 19
    tab, uniform = probe_gather.make_inputs(n, m, device="cuda")
    uniform = uniform.cpu().numpy()
    out = torch.empty(m, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    calls, res = {}, {}
    for name, per, span in (("1 per 64 B", 1, 16), ("2 per 64 B", 2, 16),
                            ("4 per 128 B", 4, 32), ("uniform", 0, 0),
                            ("uniform, sorted", 0, 0)):
        if per:
            groups = rng.permutation(n // span)[:m // per]
            ix = (groups[:, None] * span + np.arange(per)[None, :] * 8
                  + rng.integers(0, 8, (m // per, per))).reshape(-1)
            rng.shuffle(ix)
        else:
            ix = np.sort(uniform) if "sorted" in name else uniform
        idx = torch.from_numpy(ix.astype(np.int32)).cuda()
        calls[name] = (lambda idx=idx: _build.check(lib.mq3d_gather(
            tab.data_ptr(), n, idx.data_ptr(), out.data_ptr(), m, 0, stream),
            "gather granularity"))
        calls[name]()
        torch.cuda.synchronize()
        res[name] = {"equal": probe_gather.equal_bits(out, gather_plain(tab, idx)),
                     "sectors": int(torch.unique(idx // 8).numel()),
                     "segments_64b": int(torch.unique(idx // 16).numel())}
    order = list(calls)
    for name in order + order[::-1]:
        res[name].setdefault("ms", []).append(time_ms(calls[name]))
    return res


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
    floor = floor_ms()
    print(f"[floor] an empty launch under the timer: {floor:.4f} ms", flush=True)
    rng = np.random.default_rng(0)
    result = {"device": smi, "floor_ms": floor, "k1": k1(old_lib, new_lib, rng),
              "k2": k2(old_lib, new_lib, rng),
              "k3": k3(old_lib, new_lib, has_modes(args.old_csrc)),
              "k3_granularity": k3_granularity(new_lib, rng)}
    for name in ("k1", "k2"):
        r = result[name]
        print(f"[{name}] {r['shape']}: old {r['old_ms']} ms, new {r['new_ms']} ms "
              f"(old, new, new, old); mean old {r['old_mean_ms']:.4f} new "
              f"{r['new_mean_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms; new at "
              f"{r['bytes'] / r['new_mean_ms'] / 1e6:.0f} GB/s; equal old "
              f"{r['old_equal']} new {r['new_equal']}", flush=True)
    for r in result["k3"]:
        print(f"[k3] {r['table_mb']:g} MB table (fits {r['fits_in']}), {r['indices']} "
              f"indices: old {r['old_ms']} ms, new {r['new_ms']} ms (old, new, new, "
              f"old); mean old {r['old_mean_ms']:.4f} new {r['new_mean_ms']:.4f} ms; "
              f"torch.take {r['torch_take_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_ms'] / r['new_mean_ms']:.0%} of new), sector bound "
              f"{r['sector_bound_ms']:.4f} ms ({r['sector_bound_ms'] / r['new_mean_ms']:.0%}); "
              f"equal old {r['old_equal']} new {r['new_equal']}", flush=True)
    for name, v in result["k3_granularity"].items():
        print(f"[k3 granularity] 128 MB, {name}: {v['sectors']} sectors in "
              f"{v['segments_64b']} 64-byte segments: {v['ms']} ms, equal {v['equal']}",
              flush=True)
    line = json.dumps(result)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    print(line)
    ok = all(result[k][f"{w}_equal"] for k in ("k1", "k2") for w in ("old", "new"))
    ok &= all(r[f"{w}_equal"] for r in result["k3"] for w in ("old", "new"))
    ok &= all(v["equal"] for v in result["k3_granularity"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
