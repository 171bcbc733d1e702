"""Measure the CPU reference baseline of the port's bench (bench.BASELINE_FRAMES_PER_SEC).

    python -m mq3d_tpu_torch.tools.bench_reference_cpu [n_frames] [--reps 3] \
        [--parity] [--device cuda]

Counterpart of tools/bench_reference_cpu.py.  Open3D is not a dependency,
so the baseline is the C++ transcription of the allocate-then-integrate
loop that the reference runs through Open3D's CPU VoxelBlockGrid
(`mq3d_tpu_torch/csrc/ref_tsdf_cpu.cpp`, OpenMP over blocks), run on the
bench's workload: the first n_frames (default 200) frames of
`bench.make_capture()` at `bench.bench_config()` (320x288 depth, voxel
1 cm, trunc 10 voxels, 50 000 blocks).

It prints the loop's frames/s with all of the host's threads and with one
thread (the median of --reps timed runs after a warm run on 10 frames;
the volume's buffers are allocated once and stay paged in), beside the
host's CPU model and thread count, then one JSON line.  The all-threads
number is the measurement behind bench.BASELINE_FRAMES_PER_SEC; the JAX
tool instead scaled a one-core number by an assumed 16 cores x 0.8.

--parity integrates the first 20 frames with the C++ loop and with the
port's `TSDFVolume.integrate` on --device (default cuda): their total
observation counts must agree within 2 % (the update rules are the same;
the block sets may differ in order), or the tool raises.

The library is built with g++ on first use (tools/_reference.py).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time

import numpy as np

from mq3d_tpu_torch.kernels._build import CSRC_DIR, LazyLibrary
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume
from mq3d_tpu_torch.tools._reference import build_reference, host_cpu, host_threads

SOURCE = CSRC_DIR / "ref_tsdf_cpu.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
WARM_FRAMES = 10
PARITY_FRAMES = 20
PARITY_REL = 0.02

_FP = ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # (depth, n_frames, H, W, K9, Twc16, voxel, trunc, depth_max, block_res,
    #  max_blocks, alloc_stride, tsdf, weight, n_blocks_out) -> frames, -1 on
    # invalid arguments
    "ref_tsdf_integrate": (_I, (_FP, _I, _I, _I, _FP, _FP, _F, _F, _F, _I, _I, _I,
                                _FP, _FP, ctypes.POINTER(_I))),
    "ref_tsdf_num_threads": (_I, ()),
    "ref_tsdf_set_num_threads": (None, (_I,)),
}

_lib = LazyLibrary(lambda: build_reference(SOURCE, GXX_FLAGS), _SIGNATURES)


def library() -> ctypes.CDLL:
    """The reference library (built on first use)."""
    return _lib.get()


class Volume:
    """The C++ loop's voxel buffers for one config, allocated once."""

    def __init__(self, cfg: TSDFConfig):
        self.cfg = cfg
        self.tsdf = np.zeros((cfg.block_count, cfg.r3), np.float32)
        self.weight = np.zeros((cfg.block_count, cfg.r3), np.float32)
        self.n_blocks = 0

    def integrate(self, depth, K, T_wc, threads: int) -> float:
        """Integrate depth (n, H, W) from an empty volume on `threads`
        threads; returns the seconds the C++ call took."""
        cfg = self.cfg
        depth = np.ascontiguousarray(depth, np.float32)
        K = np.ascontiguousarray(K, np.float32)
        T_wc = np.ascontiguousarray(T_wc, np.float32)
        n, h, w = depth.shape
        if K.shape != (n, 3, 3) or T_wc.shape != (n, 4, 4):
            raise ValueError(f"K {K.shape} and T_wc {T_wc.shape} do not match {n} frames")
        lib = library()
        lib.ref_tsdf_set_num_threads(threads)
        n_blocks = _I(0)
        t0 = time.perf_counter()
        done = lib.ref_tsdf_integrate(
            depth.ctypes.data_as(_FP), n, h, w, K.ctypes.data_as(_FP),
            T_wc.ctypes.data_as(_FP), cfg.voxel_size, cfg.trunc, cfg.depth_max,
            cfg.block_resolution, cfg.block_count, cfg.alloc_pixel_stride,
            self.tsdf.ctypes.data_as(_FP), self.weight.ctypes.data_as(_FP),
            ctypes.byref(n_blocks))
        secs = time.perf_counter() - t0
        if done != n:
            raise RuntimeError(f"ref_tsdf_integrate returned {done} for {n} frames")
        self.n_blocks = n_blocks.value
        return secs


def measure(depth, K, T_wc, cfg: TSDFConfig, reps: int = 3, threads=None) -> dict:
    """frames/s of the C++ loop on each thread count of `threads` (default:
    all of the host's, then one): the median of `reps` timed runs after a
    warm run.  Returns {threads: {"frames_per_sec", "reps", "n_blocks"}}."""
    n = depth.shape[0]
    vol = Volume(cfg)
    out = {}
    for t in threads or (host_threads(), 1):
        vol.integrate(depth[:WARM_FRAMES], K[:WARM_FRAMES], T_wc[:WARM_FRAMES], t)
        fps = [n / vol.integrate(depth, K, T_wc, t) for _ in range(reps)]
        out[t] = {"frames_per_sec": statistics.median(fps), "reps": fps,
                  "n_blocks": vol.n_blocks,
                  "omp_threads": library().ref_tsdf_num_threads()}
    return out


def parity(depth, K, T_wc, cfg: TSDFConfig, device="cuda") -> dict:
    """Total observation counts (the sums of the weights) of the C++ loop
    and of the port's TSDFVolume.integrate on the same frames."""
    vol = Volume(cfg)
    vol.integrate(depth, K, T_wc, host_threads())
    w_cpp = float(vol.weight.sum(dtype=np.float64))
    port = TSDFVolume(cfg, device=device)
    port.integrate(depth, K, T_wc)
    st = port.state
    w_port = float(st.weight[:st.n_active].double().sum())
    return {"cpp": w_cpp, "port": w_port, "rel": abs(w_port - w_cpp) / max(w_port, 1.0),
            "cpp_blocks": vol.n_blocks, "port_blocks": st.n_active}


def main(argv=None) -> dict:
    from mq3d_tpu_torch import bench

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_frames", nargs="?", type=int, default=200)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parity", action="store_true",
                        help=f"hold the first {PARITY_FRAMES} frames against the port")
    parser.add_argument("--device", default="cuda",
                        help="device of the port's volume for --parity (default cuda)")
    args = parser.parse_args(argv)
    if args.n_frames < WARM_FRAMES or args.reps < 1:
        parser.error(f"n_frames must be at least {WARM_FRAMES}, --reps at least 1")
    host = host_cpu()
    print(f"[info] host CPU {host['cpu']}, {host['threads']} threads", flush=True)
    cfg = bench.bench_config()
    depth, K, T_wc = bench.make_capture(args.n_frames)[:3]
    res = measure(depth, K, T_wc, cfg, args.reps)
    for t, r in res.items():
        print(f"[measured] C++ on {t} thread{'s' * (t > 1)}: {r['frames_per_sec']:.2f} "
              f"frames/s, median of {args.reps} "
              f"({1e3 / r['frames_per_sec']:.1f} ms/frame, {r['n_blocks']} blocks; reps "
              f"{[round(x, 2) for x in r['reps']]})", flush=True)
    line = {"n_frames": args.n_frames, "host": host,
            "frames_per_sec": {str(t): r["frames_per_sec"] for t, r in res.items()},
            "reps": {str(t): r["reps"] for t, r in res.items()}}
    if args.parity:
        k = PARITY_FRAMES
        p = parity(depth[:k], K[:k], T_wc[:k], cfg, args.device)
        print(f"[parity] total obs over {k} frames: cpp {p['cpp']:.0f} vs port "
              f"{p['port']:.0f} (rel diff {p['rel']:.3%}); blocks {p['cpp_blocks']} vs "
              f"{p['port_blocks']}", flush=True)
        line["parity"] = p
        if not p["rel"] < PARITY_REL:
            raise RuntimeError(f"the C++ baseline diverges from the port: {p}")
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
