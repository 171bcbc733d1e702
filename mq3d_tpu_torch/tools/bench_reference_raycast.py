"""Measure the CPU reference baseline of the port's raycast (bench.BASELINE_RAYCAST_MS).

    python -m mq3d_tpu_torch.tools.bench_reference_raycast [n_frames] [--device cuda]

Counterpart of tools/bench_reference_raycast.py.  The reference renders
color-aligned depth with Embree CPU rays over the extracted mesh; Embree
is not a dependency, so `mq3d_tpu_torch/csrc/ref_raycast_cpu.cpp` stands
in for it: a binned-SAH BVH ray tracer (Moeller-Trumbore, ordered
traversal, threads over row blocks).  The workload is the bench's: a
volume of 50 frames of the 320x288 box-room orbit at the production TSDF
settings, integrated by the port on --device (default cuda), its mesh from
the port's marching cubes, rendered at 1280x960 from the first n_frames
(default 8) orbit views.

It prints the per-frame median ms with all of the host's threads and with
one thread, beside the host's CPU model and thread count, the renders'
accuracy against the analytic box depth, then one JSON line.  The
all-threads median is the measurement behind bench.BASELINE_RAYCAST_MS;
the JAX tool instead divided a one-core number by an assumed 16 cores x
0.8.  The library is built with g++ on first use (tools/_reference.py).
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
from mq3d_tpu_torch.testing.synthetic import (
    SyntheticSceneConfig,
    intrinsics_from_cfg,
    orbit_poses_o3d,
    render_box_depth,
)
from mq3d_tpu_torch.tools._reference import build_reference, host_cpu, host_threads

SOURCE = CSRC_DIR / "ref_raycast_cpu.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-pthread", "-shared", "-fPIC")
W_D, H_D = 320, 288  # depth (integration)
W_C, H_C = 1280, 960  # colour (raycast target)
N_INTEGRATE = 50
T_MAX = 100.0

_FP = ctypes.POINTER(ctypes.c_float)
_P = ctypes.c_void_p
_SIGNATURES = {
    # (verts, n_verts, tris, n_tris) -> scene, NULL for an empty mesh
    "rc_build": (_P, (_FP, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64)),
    "rc_free": (None, (_P,)),
    # (scene, K, T_cw, w, h, t_max, n_threads, out)
    "rc_render": (None, (_P, _FP, _FP, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                         ctypes.c_int32, _FP)),
}

_lib = LazyLibrary(lambda: build_reference(SOURCE, GXX_FLAGS), _SIGNATURES)


def library() -> ctypes.CDLL:
    """The reference library (built on first use)."""
    return _lib.get()


def build_volume(device="cuda", cfg: TSDFConfig = None, n_integrate: int = N_INTEGRATE,
                 w: int = W_D, h: int = H_D):
    """The port of tools/bench_raycast.py's build_volume: n_integrate
    frames of the w x h box-room orbit (misses as 0) integrated in chunks
    of 10 at `cfg` (default: the production settings).  Returns (volume,
    ground-truth poses, scene config)."""
    cfg_s = SyntheticSceneConfig(n_frames=n_integrate, depth_width=w, depth_height=h,
                                 sweep=2 * np.pi)
    fx, fy, cx, cy = intrinsics_from_cfg(cfg_s, w, h)
    cxf = w - cx
    gt = orbit_poses_o3d(cfg_s)
    poses_cw = gt.extrinsics_cw.astype(np.float64)
    depths = np.empty((n_integrate, h, w), np.float32)
    for i in range(n_integrate):
        depths[i] = render_box_depth(poses_cw[i], fx, fy, cxf, cy, w, h,
                                     np.asarray(cfg_s.box_min), np.asarray(cfg_s.box_max))
    depths = np.nan_to_num(depths, posinf=0.0)
    K = np.tile(np.eye(3, dtype=np.float32), (n_integrate, 1, 1))
    K[:, 0, 0], K[:, 1, 1] = fx, fy
    K[:, 0, 2], K[:, 1, 2] = cxf, cy
    T_wc = np.linalg.inv(poses_cw).astype(np.float32)
    vol = TSDFVolume(cfg or TSDFConfig(), device=device)
    for s in range(0, n_integrate, 10):
        vol.integrate(depths[s:s + 10], K[s:s + 10], T_wc[s:s + 10])
    return vol, gt, cfg_s


class Scene:
    """The C++ BVH over a triangle mesh, freed on close."""

    def __init__(self, vertices, triangles):
        self._verts = np.ascontiguousarray(vertices, np.float32)
        self._tris = np.ascontiguousarray(triangles, np.int32)
        if self._tris.size and (self._tris.min() < 0 or self._tris.max() >= len(self._verts)):
            raise ValueError("triangle indices out of range")
        self.handle = library().rc_build(
            self._verts.ctypes.data_as(_FP), len(self._verts),
            self._tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(self._tris))

    def render(self, K, T_cw, w: int, h: int, threads: int) -> np.ndarray:
        """(h, w) z-depth from camera-to-world T_cw with intrinsics K
        (cx mirror-flipped) on `threads` threads; misses are inf."""
        K = np.ascontiguousarray(K, np.float32)
        T_cw = np.ascontiguousarray(T_cw, np.float32)
        if K.shape != (3, 3) or T_cw.shape != (4, 4):
            raise ValueError(f"K {K.shape}, T_cw {T_cw.shape}")
        out = np.empty((h, w), np.float32)
        library().rc_render(self.handle, K.ctypes.data_as(_FP), T_cw.ctypes.data_as(_FP),
                            w, h, T_MAX, threads, out.ctypes.data_as(_FP))
        return out

    def close(self) -> None:
        if self.handle:
            library().rc_free(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def view_intrinsics(cfg_s: SyntheticSceneConfig, w: int = W_C, h: int = H_C) -> np.ndarray:
    fx, fy, cx, cy = intrinsics_from_cfg(cfg_s, w, h)
    return np.array([[fx, 0, w - cx], [0, fy, cy], [0, 0, 1]], np.float32)


def analytic_depth(gt, cfg_s: SyntheticSceneConfig, i: int, w: int = W_C,
                   h: int = H_C) -> np.ndarray:
    K = view_intrinsics(cfg_s, w, h)
    return render_box_depth(gt.extrinsics_cw[i % len(gt.extrinsics_cw)], K[0, 0], K[1, 1],
                            K[0, 2], K[1, 2], w, h, np.asarray(cfg_s.box_min),
                            np.asarray(cfg_s.box_max))


def measure(scene: Scene, gt, cfg_s: SyntheticSceneConfig, n_frames: int, threads=None,
            w: int = W_C, h: int = H_C) -> dict:
    """Per-frame ms of the first n_frames orbit views on each thread count
    of `threads` (default: all of the host's, then one).  Returns
    {threads: {"ms_per_frame" (median), "reps" (each frame's ms),
    "depth" (the last frame's render)}}."""
    K = view_intrinsics(cfg_s, w, h)
    out = {}
    for t in threads or (host_threads(), 1):
        times, d = [], None
        for i in range(n_frames):
            T_cw = gt.extrinsics_cw[i % len(gt.extrinsics_cw)]
            t0 = time.perf_counter()
            d = scene.render(K, T_cw, w, h, t)
            times.append((time.perf_counter() - t0) * 1e3)
        out[t] = {"ms_per_frame": statistics.median(times), "reps": times, "depth": d}
    return out


def accuracy(depth: np.ndarray, ref: np.ndarray) -> dict:
    """|depth - ref| over the pixels both hit: median and p95 in mm, and
    the share of such pixels."""
    m = np.isfinite(depth) & np.isfinite(ref)
    err = np.abs(depth[m] - ref[m])
    if not err.size:
        return {"median_mm": float("nan"), "p95_mm": float("nan"), "coverage": 0.0}
    return {"median_mm": float(np.median(err) * 1e3),
            "p95_mm": float(np.percentile(err, 95) * 1e3), "coverage": float(m.mean())}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_frames", nargs="?", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="device of the port's volume and marching cubes (default cuda)")
    args = parser.parse_args(argv)
    if args.n_frames < 1:
        parser.error("n_frames must be at least 1")
    host = host_cpu()
    print(f"[info] host CPU {host['cpu']}, {host['threads']} threads", flush=True)
    t0 = time.perf_counter()
    vol, gt, cfg_s = build_volume(args.device)
    mesh = vol.extract_triangle_mesh(3.0)
    print(f"[info] volume {vol.n_active} blocks; mesh {len(mesh.vertices)} vertices, "
          f"{len(mesh.triangles)} triangles from the port's marching cubes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    with Scene(mesh.vertices, mesh.triangles) as scene:
        print(f"[info] BVH build {time.perf_counter() - t0:.2f} s", flush=True)
        res = measure(scene, gt, cfg_s, args.n_frames)
    ref = analytic_depth(gt, cfg_s, args.n_frames - 1)
    depths = [r.pop("depth") for r in res.values()]
    same = all(np.array_equal(depths[0], d, equal_nan=True) for d in depths[1:])
    acc = accuracy(depths[0], ref)
    for t, r in res.items():
        print(f"[measured] per frame on {t} thread{'s' * (t > 1)}: median "
              f"{r['ms_per_frame']:.1f} ms, min {min(r['reps']):.1f}, max "
              f"{max(r['reps']):.1f} ({W_C}x{H_C}, {len(mesh.triangles)} triangles)",
              flush=True)
    print(f"[accuracy] last view against the analytic depth: median {acc['median_mm']:.2f} "
          f"mm, p95 {acc['p95_mm']:.2f} mm, coverage {acc['coverage']:.1%}; renders equal "
          f"across thread counts: {same}", flush=True)
    if not same:
        raise RuntimeError("the C++ renders differ between thread counts")
    line = {"n_frames": args.n_frames, "host": host, "triangles": len(mesh.triangles),
            "ms_per_frame": {str(t): r["ms_per_frame"] for t, r in res.items()},
            "reps": {str(t): r["reps"] for t, r in res.items()}, "accuracy": acc}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
