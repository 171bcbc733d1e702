"""Measure the CPU baselines of confidence reprojection (B9) and a multiscale-ICP pair (B10).

    python -m mq3d_tpu_torch.tools.bench_reference_stages [--parity] \
        [--device cuda] [--conf-reps 10] [--icp-reps 3]

Counterpart of tools/bench_reference_stages.py.  The reference runs both
stages on the CPU (numpy and a process pool for confidence, Open3D's
multi_scale_icp for the pairs); Open3D is not a dependency, so the
baselines are the C++ transcriptions of the same workloads, the port's
copies `mq3d_tpu_torch/csrc/ref_confidence_cpu.cpp` and
`ref_icp_cpu.cpp`, built with g++ on first use (tools/_reference.py).

Confidence: the 41-frame 320x288 box-room orbit (sweep 0.6 rad) of the
port's testing/synthetic.py, window 10, depth_max 4 m, error threshold
0.08 m (config/pipeline_config.yml).  ICP: 500 000 points on five faces
of a 6 x 5 x 3 m box with 3 mm noise against the same cloud turned by
0.02 rad of yaw and shifted by (0.04, -0.03, 0.02) m, pyramid voxels
[0.05, 0.025, 0.0125] m, distances [0.1, 0.05, 0.025] m, iterations
[50, 31, 14].

It prints the JAX tool's lines: the time per reference frame and per pair
on one thread (the mean of the reps after a warm run), and beside each
the time on all of the host's threads, one reference frame or pair per
thread (wall time / frames, the mean of the reps), with the host's CPU
and thread count; then one JSON line.

--parity runs the port's `recon/confidence.py::confidence_for_refs` and
`ops/icp.py::multi_scale_icp` on --device (default cuda) on the same
inputs: the share of equal valid counts and the p99 of |dconf| against
the C++ map, both residual rotations, and the port's time per reference
frame (one pass of 16 reference frames, the pipeline's frames_per_batch)
and per pair after a warm call, synchronized: B9 and B10 on the card at
the reference's workload.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.kernels._build import CSRC_DIR, LazyLibrary
from mq3d_tpu_torch.testing.synthetic import (
    SyntheticSceneConfig,
    intrinsics_from_cfg,
    orbit_poses_o3d,
    render_box_depth,
)
from mq3d_tpu_torch.tools._reference import build_reference, host_cpu, host_threads

CONF_SOURCE = CSRC_DIR / "ref_confidence_cpu.cpp"
ICP_SOURCE = CSRC_DIR / "ref_icp_cpu.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-pthread", "-shared", "-fPIC")

H, W = 288, 320
N_FRAMES = 41
SWEEP = 0.6
WINDOW = 10
DEPTH_MAX = 4.0
ERROR_THRESHOLD = 0.08  # config/pipeline_config.yml:36
PORT_REFS = 16  # config/pipeline_config.yml:39, confidence frames_per_batch

ICP_POINTS = 500_000
ICP_NOISE = 0.003
ICP_YAW = 0.02
ICP_SHIFT = (0.04, -0.03, 0.02)
VOXELS = (0.05, 0.025, 0.0125)
DISTS = (0.1, 0.05, 0.025)
ITERS = (50, 31, 14)

_FP = ctypes.POINTER(ctypes.c_float)
_DP = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
_CONF_SIGNATURES = {
    # (depth, n, h, w, K9, T_cw12, T_wc12, ref, window, depth_max, threshold,
    #  conf, count) -> 0, -1 on invalid arguments
    "conf_build_map": (ctypes.c_int, (_FP, _I64, _I64, _I64, _FP, _FP, _FP, _I64, _I64,
                                      ctypes.c_float, ctypes.c_float, _FP, _I32P)),
    # (..., refs, n_refs, window, depth_max, threshold, n_threads, conf, count)
    "conf_build_maps": (ctypes.c_int, (_FP, _I64, _I64, _I64, _FP, _FP, _FP, _I64P, _I64,
                                       _I64, ctypes.c_float, ctypes.c_float, ctypes.c_int32,
                                       _FP, _I32P)),
}
_ICP_SIGNATURES = {
    # (src, n_src, dst, n_dst, voxels, dists, iters, n_scales, T16, fitness,
    #  rmse, iters_out) -> 0, -1 on invalid arguments
    "icp_multiscale": (ctypes.c_int, (_FP, _I64, _FP, _I64, _FP, _FP, _I32P, _I64, _DP, _DP,
                                      _DP, _I32P)),
    # (srcs, n_srcs, dsts, n_dsts, n_pairs, voxels, dists, iters, n_scales,
    #  n_threads, T16 each, fitness, rmse, iters_out)
    "icp_multiscale_pairs": (ctypes.c_int, (ctypes.POINTER(_FP), _I64P, ctypes.POINTER(_FP),
                                            _I64P, _I64, _FP, _FP, _I32P, _I64, ctypes.c_int32,
                                            _DP, _DP, _DP, _I32P)),
}

_conf_lib = LazyLibrary(lambda: build_reference(CONF_SOURCE, GXX_FLAGS), _CONF_SIGNATURES)
_icp_lib = LazyLibrary(lambda: build_reference(ICP_SOURCE, GXX_FLAGS), _ICP_SIGNATURES)


def conf_library() -> ctypes.CDLL:
    """The confidence reference library (built on first use)."""
    return _conf_lib.get()


def icp_library() -> ctypes.CDLL:
    """The ICP reference library (built on first use)."""
    return _icp_lib.get()


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


# -- confidence -------------------------------------------------------------


def make_capture(n_frames: int, h: int, w: int):
    """The JAX tool's capture: n_frames of the box-room orbit (sweep 0.6)
    at w x h, misses as 0.  Returns (depth (n, h, w), K (n, 9), T_cw
    (n, 12), T_wc (n, 12), all float32 row-major, and the float64
    camera-to-world poses (n, 4, 4))."""
    cfg = SyntheticSceneConfig(n_frames=n_frames, depth_width=w, depth_height=h, sweep=SWEEP)
    fx, fy, cx, cy = intrinsics_from_cfg(cfg, w, h)
    cxf = w - cx
    poses_cw = orbit_poses_o3d(cfg).extrinsics_cw.astype(np.float64)
    depth = np.empty((n_frames, h, w), np.float32)
    for i in range(n_frames):
        depth[i] = render_box_depth(poses_cw[i], fx, fy, cxf, cy, w, h,
                                    np.asarray(cfg.box_min), np.asarray(cfg.box_max))
    depth = np.nan_to_num(depth, posinf=0.0)
    K = np.zeros((n_frames, 9), np.float32)
    K[:, 0], K[:, 4] = fx, fy
    K[:, 2], K[:, 5] = cxf, cy
    K[:, 8] = 1
    T_cw = poses_cw[:, :3, :].reshape(n_frames, 12).astype(np.float32)
    T_wc = np.linalg.inv(poses_cw)[:, :3, :].reshape(n_frames, 12).astype(np.float32)
    return depth, K, T_cw, T_wc, poses_cw


def confidence_maps(depth, K, T_cw, T_wc, refs, threads: int, window: int):
    """The C++ maps of the reference frames `refs` on `threads` threads.
    Returns (confidence (R, h*w) float32, valid count (R, h*w) int32)."""
    depth = np.ascontiguousarray(depth, np.float32)
    K, T_cw, T_wc = (np.ascontiguousarray(a, np.float32) for a in (K, T_cw, T_wc))
    refs = np.ascontiguousarray(refs, np.int64)
    n, h, w = depth.shape
    conf = np.zeros((len(refs), h * w), np.float32)
    cnt = np.zeros((len(refs), h * w), np.int32)
    rc = conf_library().conf_build_maps(
        _ptr(depth, _FP), n, h, w, _ptr(K, _FP), _ptr(T_cw, _FP), _ptr(T_wc, _FP),
        _ptr(refs, _I64P), len(refs), window, DEPTH_MAX, ERROR_THRESHOLD, threads,
        _ptr(conf, _FP), _ptr(cnt, _I32P))
    if rc != 0:
        raise ValueError(f"conf_build_maps returned {rc}: {n} frames of {w}x{h}, "
                         f"refs {refs.tolist()}, window {window}")
    return conf, cnt


def _mean_seconds(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for r in range(reps):
        fn(r)
    return (time.perf_counter() - t0) / reps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def port_inputs(capture, device) -> list:
    """The capture as confidence_for_refs' inputs on `device`: depth, K
    (n, 3, 3), T_cw, T_wc (n, 4, 4) float32 and every frame valid."""
    depth, K, _, _, poses_cw = capture
    n = depth.shape[0]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        depth, K.reshape(n, 3, 3), poses_cw.astype(np.float32),
        np.linalg.inv(poses_cw).astype(np.float32), np.ones(n, bool))]


def port_confidence(inputs, refs):
    """The port's confidence_for_refs for `refs` on the inputs' device.
    Returns (confidence (R, h, w), valid count (R, h, w)) tensors."""
    from mq3d_tpu_torch.recon.confidence import confidence_for_refs

    refs = torch.as_tensor(np.asarray(refs), device=inputs[0].device)
    return confidence_for_refs(*inputs, refs, DEPTH_MAX, ERROR_THRESHOLD, WINDOW)


def confidence_parity(cpp_conf, cpp_cnt, port_conf, port_cnt) -> dict:
    """The share of pixels with equal valid counts and the p99 of |dconf|."""
    return {"valid_count_match": float((np.asarray(port_cnt) == cpp_cnt).mean()),
            "conf_abs_diff_p99": float(np.percentile(np.abs(port_conf - cpp_conf), 99))}


def bench_confidence(reps: int = 10, parity: bool = False, device="cuda") -> dict:
    capture = make_capture(N_FRAMES, H, W)
    depth, K, T_cw, T_wc, _ = capture
    n, h, w = depth.shape
    run = lambda refs, t: confidence_maps(depth, K, T_cw, T_wc, refs, t, WINDOW)  # noqa: E731
    run([WINDOW], 1)  # warm
    one = _mean_seconds(lambda r: run([WINDOW + r % 3], 1), reps)
    threads = host_threads()
    span = n - 2 * WINDOW  # reference frames with a whole window
    refs = [WINDOW + i % span for i in range(threads)]
    run(refs, threads)  # warm
    many = _mean_seconds(lambda r: run(refs, threads), reps) / len(refs)
    print(f"confidence C++ single-core: {one * 1e3:.1f} ms/ref-frame ({1 / one:.2f} f/s) at "
          f"{w}x{h}, window {WINDOW}", flush=True)
    print(f"  all {threads} threads (one reference frame each): {many * 1e3:.2f} ms/ref-frame "
          f"({1 / many:.2f} f/s)", flush=True)
    print(f"  1000-frame stage: {1000 * one:.0f} s single-core, {1000 * many:.1f} s on "
          f"{threads} threads", flush=True)
    out = {"ms_per_ref_frame": {"1": one * 1e3, str(threads): many * 1e3}, "reps": reps}
    if parity:
        dev = resolve_device(device)
        conf, cnt = run([WINDOW], 1)
        inputs = port_inputs(capture, dev)
        pconf, pcnt = (x.reshape(1, -1).cpu().numpy() for x in port_confidence(inputs, [WINDOW]))
        out["parity"] = confidence_parity(conf, cnt, pconf, pcnt)
        batch = [WINDOW + i % span for i in range(PORT_REFS)]
        port_confidence(inputs, batch)  # warm
        times = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            port_confidence(inputs, batch)
            _sync(dev)
            times.append((time.perf_counter() - t0) / len(batch))
        out["port_ms_per_ref_frame"] = float(np.mean(times) * 1e3)
        out["port_device"] = str(dev)
        print(f"  parity vs mq3d_tpu_torch confidence_for_refs: valid_count match "
              f"{out['parity']['valid_count_match']:.4f}, conf |diff| p99 "
              f"{out['parity']['conf_abs_diff_p99']:.4f}", flush=True)
        print(f"  port on {dev}: {out['port_ms_per_ref_frame']:.3f} ms/ref-frame (passes of "
              f"{len(batch)} reference frames on inputs already on the device, mean of "
              f"{reps} after a warm pass)", flush=True)
    return out


# -- ICP --------------------------------------------------------------------


def make_clouds(n_pts: int, seed: int = 0):
    """The JAX tool's pair: n_pts points on five faces of a 6 x 5 x 3 m
    box with ICP_NOISE noise (dst) and the same points turned by ICP_YAW
    about z, shifted by ICP_SHIFT and shuffled (src).  Returns (src, dst,
    Rz)."""
    rng = np.random.default_rng(seed)
    per = n_pts // 5
    faces = []
    for axis, lo_hi in ((0, 0.0), (0, 6.0), (1, 0.0), (1, 5.0), (2, 0.0)):
        p = rng.uniform(0, 1, (per, 3)) * np.array([6.0, 5.0, 3.0])
        p[:, axis] = lo_hi
        faces.append(p)
    dst = np.concatenate(faces).astype(np.float32)
    dst += rng.normal(0, ICP_NOISE, dst.shape).astype(np.float32)
    c, s = np.cos(ICP_YAW), np.sin(ICP_YAW)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = dst @ Rz.T + np.array(ICP_SHIFT, np.float32)
    src = np.ascontiguousarray(src[rng.permutation(len(src))])
    return src, dst, Rz


def _pyramid():
    return (np.asarray(VOXELS, np.float32), np.asarray(DISTS, np.float32),
            np.asarray(ITERS, np.int32))


def icp_pairs(pairs, threads: int = 1) -> list:
    """The C++ multiscale ICP of each (src, dst) in `pairs` on `threads`
    threads.  Returns one dict per pair: T (4, 4) float64, fitness, rmse,
    iterations."""
    pairs = [(np.ascontiguousarray(s, np.float32), np.ascontiguousarray(d, np.float32))
             for s, d in pairs]
    voxels, dists, iters = _pyramid()
    m = len(pairs)
    srcs = (_FP * max(m, 1))(*[_ptr(s, _FP) for s, _ in pairs])
    dsts = (_FP * max(m, 1))(*[_ptr(d, _FP) for _, d in pairs])
    n_src = np.asarray([len(s) for s, _ in pairs] or [0], np.int64)
    n_dst = np.asarray([len(d) for _, d in pairs] or [0], np.int64)
    T = np.zeros((max(m, 1), 16), np.float64)
    fit, rmse = np.zeros(max(m, 1)), np.zeros(max(m, 1))
    it = np.zeros(max(m, 1), np.int32)
    rc = icp_library().icp_multiscale_pairs(
        srcs, _ptr(n_src, _I64P), dsts, _ptr(n_dst, _I64P), m, _ptr(voxels, _FP),
        _ptr(dists, _FP), _ptr(iters, _I32P), len(voxels), threads, _ptr(T, _DP),
        _ptr(fit, _DP), _ptr(rmse, _DP), _ptr(it, _I32P))
    if rc != 0:
        raise ValueError(f"icp_multiscale_pairs returned {rc}: {m} pairs of "
                         f"{n_src.tolist()} / {n_dst.tolist()} points")
    return [{"T": T[p].reshape(4, 4), "fitness": float(fit[p]), "rmse": float(rmse[p]),
             "iterations": int(it[p])} for p in range(m)]


def residual_rotation_deg(T: np.ndarray, Rz: np.ndarray) -> float:
    """The angle of T's rotation composed with the applied one: 0 when T
    inverts the perturbation."""
    R = np.asarray(T)[:3, :3] @ Rz
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def port_icp(src, dst, device):
    from mq3d_tpu_torch.ops.icp import ICPConvergenceCriteria, multi_scale_icp

    return multi_scale_icp(src, dst, voxel_sizes=list(VOXELS),
                           criteria_list=[ICPConvergenceCriteria(i) for i in ITERS],
                           max_correspondence_distances=list(DISTS), device=device)


def bench_icp(reps: int = 3, parity: bool = False, device="cuda") -> dict:
    src, dst, Rz = make_clouds(ICP_POINTS)
    icp_pairs([(src, dst)])  # warm (allocator, page faults)
    res = {}
    one = _mean_seconds(lambda r: res.update(icp_pairs([(src, dst)])[0]), reps)
    threads = host_threads()
    many = _mean_seconds(lambda r: icp_pairs([(src, dst)] * threads, threads),
                         reps) / threads
    ang = residual_rotation_deg(res["T"], Rz)
    print(f"multiscale ICP C++ single-core: {one:.2f} s/pair ({len(src)} pts, "
          f"{res['iterations']} total iters, fitness {res['fitness']:.3f}, rmse "
          f"{res['rmse'] * 1e3:.2f} mm)", flush=True)
    print(f"  all {threads} threads (one pair each): {many:.3f} s/pair", flush=True)
    print(f"  transform check: residual rotation {ang:.4f} deg", flush=True)
    out = {"s_per_pair": {"1": one, str(threads): many}, "reps": reps, "points": len(src),
           "iterations": res["iterations"], "fitness": res["fitness"], "rmse": res["rmse"],
           "residual_rotation_deg": ang}
    if parity:
        dev = resolve_device(device)
        t0 = time.perf_counter()
        port_icp(src, dst, dev)  # warm
        warm = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            p = port_icp(src, dst, dev)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        out["port"] = {"fitness": float(p.fitness), "rmse": float(p.inlier_rmse),
                       "residual_rotation_deg": residual_rotation_deg(p.transformation, Rz),
                       "s_per_pair": float(np.mean(times)), "warm_s": warm,
                       "device": str(dev)}
        print(f"  mq3d_tpu_torch multi_scale_icp on {dev}: fitness {p.fitness:.3f}, "
              f"residual rotation {out['port']['residual_rotation_deg']:.4f} deg, "
              f"{out['port']['s_per_pair']:.3f} s/pair (mean of {reps} after a "
              f"{warm:.1f} s warm call)", flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parity", action="store_true",
                        help="run the port's confidence and ICP on --device beside the C++")
    parser.add_argument("--device", default="cuda",
                        help="device of the port's stages for --parity (default cuda; "
                             "without CUDA the tool raises unless it is 'cpu')")
    parser.add_argument("--conf-reps", type=int, default=10)
    parser.add_argument("--icp-reps", type=int, default=3)
    args = parser.parse_args(argv)
    if args.conf_reps < 1 or args.icp_reps < 1:
        parser.error("--conf-reps and --icp-reps must be at least 1")
    resolve_device(args.device)  # raises without CUDA unless --device cpu
    host = host_cpu()
    print(f"[info] host CPU {host['cpu']}, {host['threads']} threads", flush=True)
    line = {"host": host,
            "confidence": bench_confidence(args.conf_reps, args.parity, args.device),
            "icp": bench_icp(args.icp_reps, args.parity, args.device)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
