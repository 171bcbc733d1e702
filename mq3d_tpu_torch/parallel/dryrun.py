"""The sharded paths once at tiny shapes and once at the production shape.

Counterpart of __graft_entry__.py (`entry`, `dryrun_multichip`).  Also
holds `rank_run`, the rank function that the tests and chip_smoke.py start
with `spawn_ranks`: a spawned rank imports this module and the port, never
a test module (those import jax).

`rank_run(group, device, jobs)` runs a list of (kind, params) jobs in order
and returns one result per job.  Every rank returns digests (sha256 of the
bytes) of what it holds, so the caller can check that all ranks hold the
same thing; rank 0 also returns the arrays.  Kinds:

  integrate   integrate_dataset_sharded, replicated and/or partitioned:
              counters, kernel launches (K5 on the card) and the tile
              loop's patch tiles per rank, partitioned rows ==
              replicated rows bit for bit, pad rows zero
  raycast     sharded_raycast_batch on the integrated volume (or one made
              from the job's frames), optionally of the first `views` views
              that render alone without edge overflow; rank 0 also renders
              single-process
  confidence  sharded_confidence_step
  icp         registration_icp_batch over the group; rank 0 also unsharded
  gn          color_opt._gn_terms_sharded; rank 0 also _gn_terms
  rollup      multihost.rollup_statuses of a strided share, session 1 failing
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops import tsdf as tsdf_ops
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume, create_state, integrate_chunk
from mq3d_tpu_torch.parallel.dist import rank_of, spawn_ranks, world_of
from mq3d_tpu_torch.parallel.sharded import (
    gather_partitioned,
    integrate_dataset_sharded,
    padded_rows,
    sharded_confidence_step,
    sharded_raycast_batch,
)

# JAX's __graft_entry__.py production shape (config/pipeline_config.yml):
# 1 cm voxels, a 50 000-block pool, 320x288 depth, 1280x960 raycast.
PRODUCTION_CFG = TSDFConfig(
    voxel_size=0.01, block_resolution=16, block_count=50_000, grid_dim=160,
    depth_max=4.0, trunc_voxel_multiplier=10.0, alloc_pixel_stride=2,
    chunk_active_capacity=12_288, integrate_tile=512)


def tiny_cfg() -> TSDFConfig:
    return TSDFConfig(voxel_size=0.05, block_resolution=16, block_count=512, grid_dim=16,
                      depth_max=4.0, trunc_voxel_multiplier=4.0, alloc_pixel_stride=2,
                      chunk_active_capacity=512, integrate_tile=128)


def tiny_frames(n_frames: int, h: int = 32, w: int = 40):
    """Synthetic wall-depth frames, intrinsics, poses and validity (the JAX
    dryrun's `_tiny_frames`, same seed)."""
    rng = np.random.default_rng(0)
    depth = np.full((n_frames, h, w), 2.0, np.float32)
    depth += rng.uniform(-0.05, 0.05, depth.shape).astype(np.float32)
    K = np.tile(np.eye(3, dtype=np.float32), (n_frames, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 30.0
    K[:, 0, 2] = w / 2.0
    K[:, 1, 2] = h / 2.0
    T = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    T[:, 0, 3] = np.linspace(-0.2, 0.2, n_frames)
    return depth, K, T, np.ones(n_frames, bool)


def entry(device="cuda"):
    """(fn, example_args): one integrate_chunk of 4 frames at the tiny
    config; fn(*args) returns the updated state."""
    cfg = tiny_cfg()
    depth, K, T, valid = tiny_frames(4)
    dev = torch.device(device)

    def fn(state, depth, K, T, valid):
        return integrate_chunk(cfg, state, depth, K, T, valid)

    args = (create_state(cfg, device), torch.from_numpy(depth).to(dev),
            torch.from_numpy(K).to(dev), torch.from_numpy(T).to(dev),
            torch.from_numpy(valid).to(dev))
    return fn, args


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _job_integrate(group, device, p, ctx):
    cfg = p["cfg"]
    args = (p["depth"], p["K"], p["T"], p["valid"])
    out, states = {}, {}
    for mode in p.get("modes", ("replicated", "partitioned")):
        _build.reset_launch_counts()
        tsdf_ops.reset_lookup_tile_counts()
        _sync(device)
        t0 = time.perf_counter()
        states[mode] = integrate_dataset_sharded(
            cfg, group, *args, frames_per_rank_chunk=p["frames_per_rank_chunk"],
            partition_state=mode == "partitioned", device=device)
        _sync(device)
        out[mode] = {"seconds": time.perf_counter() - t0,
                     "launches": _build.launch_counts(),
                     "tiles": tsdf_ops.lookup_tile_counts()}
    st = states.get("replicated")
    if st is None:
        st = gather_partitioned(cfg, states["partitioned"], group)
    n = st.n_active
    res = {"modes": out, "n_active": n, "overflow": st.overflow,
           "dropped_active": st.dropped_active,
           "digest_tables": digest(st.slot_table, st.block_coords),
           "digest_volume": digest(st.tsdf[:n], st.weight[:n])}
    if "partitioned" in states and "replicated" in states:
        part = states["partitioned"]
        rows = padded_rows(cfg, world_of(group)) // world_of(group)
        r0 = rank_of(group) * rows
        real = max(min(cfg.block_count + 1 - r0, rows), 0)  # rows before the padding
        res["partitioned_equal"] = bool(
            torch.equal(part.slot_table, st.slot_table)
            and torch.equal(part.block_coords, st.block_coords)
            and part.n_active == st.n_active
            and torch.equal(part.tsdf[:real], st.tsdf[r0:r0 + real])
            and torch.equal(part.weight[:real], st.weight[r0:r0 + real]))
        res["pad_rows_zero"] = bool((part.tsdf[real:] == 0).all() and (part.weight[real:] == 0).all())
    if rank_of(group) == 0:
        res["arrays"] = {"slot_table": _np(st.slot_table), "block_coords": _np(st.block_coords[:n]),
                         "tsdf": _np(st.tsdf[:n]), "weight": _np(st.weight[:n])}
    ctx["volume"] = TSDFVolume(cfg, st)
    return res


def _job_raycast(group, device, p, ctx):
    from mq3d_tpu_torch.ops.raycast import _render_frames_device

    if "frames" in p:
        f = p["frames"]
        ctx["volume"] = TSDFVolume(f["cfg"], integrate_dataset_sharded(
            f["cfg"], group, f["depth"], f["K"], f["T"], f["valid"],
            frames_per_rank_chunk=f["frames_per_rank_chunk"], device=device))
    vol = ctx["volume"]
    Kc, Tc, w, h = p["K"], p["T"], p["width"], p["height"]
    res = {}
    if "views" in p:
        # Only views whose own render keeps within the edge budget: a
        # frame that overflows keeps upsampled depth at pixels that depend
        # on how the budget is shared, so it matches no other split.  A
        # view that fits alone fits any batch (the budget is per frame).
        fits = [i for i in range(len(Kc))
                if int(_render_frames_device(vol, Kc[i:i + 1], Tc[i:i + 1], w, h)[1]) == 0]
        keep = fits[:p["views"]]
        if len(keep) < p["views"]:
            raise ValueError(f"{len(fits)} of {len(Kc)} views render without edge "
                             f"overflow; {p['views']} needed")
        Kc, Tc = Kc[keep], Tc[keep]
        res.update(views_kept=keep, views_fitting=len(fits), views_offered=len(p["K"]))
    _sync(device)
    t0 = time.perf_counter()
    z, overflow = sharded_raycast_batch(vol, group, Kc, Tc, w, h)
    _sync(device)
    res.update(seconds=time.perf_counter() - t0, overflow=overflow, digest=digest(z),
               n_active=vol.n_active)
    if rank_of(group) == 0:
        z1, o1 = _render_frames_device(vol, Kc, Tc, w, h)
        res.update(z=z, z_single=z1.cpu().numpy(), overflow_single=int(o1))
    return res


def _job_confidence(group, device, p, ctx):
    dev = torch.device(device)
    t = [torch.from_numpy(np.asarray(p[k])).to(dev)
         for k in ("depth", "K", "T_cw", "T_wc", "valid", "refs")]
    fn = sharded_confidence_step(group)(p["depth_max"], p["error_threshold"], p["window"])
    conf, cnt = fn(*t)
    res = {"digest": digest(conf, cnt)}
    if rank_of(group) == 0:
        res.update(confidence=_np(conf), count=_np(cnt))
    return res


def _icp_arrays(results):
    return {"T": np.stack([r.transformation for r in results]),
            "fitness": np.asarray([r.fitness for r in results]),
            "rmse": np.asarray([r.inlier_rmse for r in results]),
            "n": np.asarray([r.n_correspondences for r in results])}


def _job_icp(group, device, p, ctx):
    from mq3d_tpu_torch.ops.icp import ICPConvergenceCriteria, build_grid_nn, registration_icp_batch

    grids = [build_grid_nn(t, mc) for t, mc in zip(p["targets"], p["max_corrs"])]
    crit = [ICPConvergenceCriteria(p["max_iteration"])] * len(grids)
    inits = p.get("inits")
    _sync(device)
    t0 = time.perf_counter()
    sharded = _icp_arrays(registration_icp_batch(p["sources"], grids, p["max_corrs"], inits,
                                                 crit, group=group, device=device))
    _sync(device)
    res = {"seconds": time.perf_counter() - t0, "digest": digest(*sharded.values())}
    if rank_of(group) == 0:
        res["sharded"] = sharded
        res["plain"] = _icp_arrays(registration_icp_batch(p["sources"], grids, p["max_corrs"],
                                                          inits, crit, device=device))
    return res


def _job_gn(group, device, p, ctx):
    from mq3d_tpu_torch.recon.color_opt import _gn_terms, _gn_terms_sharded

    dev = torch.device(device)
    src = torch.load(p["path"]) if "path" in p else p["inputs"]
    args = [torch.as_tensor(src[k]).to(dev)
            for k in ("verts", "K", "T", "gray", "gx", "gy", "target", "vis")]
    _sync(device)
    t0 = time.perf_counter()
    terms = [_np(x) for x in _gn_terms_sharded(group, *args)]
    _sync(device)
    res = {"seconds": time.perf_counter() - t0, "digest": digest(*terms),
           "frames": int(args[1].shape[0]), "vertices": int(args[0].shape[0])}
    if rank_of(group) == 0:
        res["sharded"] = terms
        res["plain"] = [_np(x) for x in _gn_terms(*args)]
    return res


def _job_rollup(group, device, p, ctx):
    from mq3d_tpu_torch.parallel.multihost import _rank_batch_dryrun

    return _rank_batch_dryrun(group, device, p["n_sessions"])


_JOBS = {"integrate": _job_integrate, "raycast": _job_raycast,
         "confidence": _job_confidence, "icp": _job_icp, "gn": _job_gn,
         "rollup": _job_rollup}


def rank_run(group, device, jobs):
    """Run `jobs`, a list of (kind, params), in order on this rank (see
    the module doc); returns one result per job."""
    ctx: dict = {}
    return [_JOBS[kind](group, device, params, ctx) for kind, params in jobs]


def _icp_pairs(n_pairs: int):
    """The JAX dryrun's pairs: a uniform cloud and a slightly shifted copy."""
    rng = np.random.default_rng(1)
    tgt = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    sources = [tgt + rng.uniform(-0.01, 0.01, 3).astype(np.float32) for _ in range(n_pairs)]
    return {"sources": sources, "targets": [tgt] * n_pairs, "max_corrs": [0.1] * n_pairs,
            "max_iteration": 5}


def dryrun_jobs(n: int):
    """The jobs of dryrun_multichip on n ranks, in its order: tiny
    replicated and partitioned integration, sharded pair-ICP (n + 1 pairs,
    so the padding runs), sharded raycast, the batch roll-up; then
    partitioned integration at the production shape (one frame per rank)
    and a 1280x960 raycast of it, one frame per rank."""
    depth, K, T, valid = tiny_frames(2 * n)
    Kc = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    Kc[:, 0, 0] = Kc[:, 1, 1] = 30.0
    Kc[:, 0, 2], Kc[:, 1, 2] = 20.0, 16.0
    Tc = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    h_d, w_d = 288, 320
    depth_p, K_p, T_p, valid_p = tiny_frames(n, h=h_d, w=w_d)
    K_p[:, 0, 0] = K_p[:, 1, 1] = 240.0
    K_p[:, 0, 2], K_p[:, 1, 2] = w_d / 2.0, h_d / 2.0
    Kr = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    Kr[:, 0, 0] = Kr[:, 1, 1] = 1000.0
    Kr[:, 0, 2], Kr[:, 1, 2] = 640.0, 480.0
    return [
        ("integrate", {"cfg": tiny_cfg(), "depth": depth, "K": K, "T": T, "valid": valid,
                       "frames_per_rank_chunk": 2}),
        ("icp", _icp_pairs(n + 1)),
        ("raycast", {"K": Kc, "T": Tc, "width": 40, "height": 32}),
        ("rollup", {"n_sessions": 7}),
        ("integrate", {"cfg": PRODUCTION_CFG, "depth": depth_p, "K": K_p, "T": T_p,
                       "valid": valid_p, "frames_per_rank_chunk": 1,
                       "modes": ("partitioned",)}),
        ("raycast", {"K": Kr, "T": Tc, "width": 1280, "height": 960}),
    ]


def check_dryrun(out, n: int, device, backend: str) -> None:
    """The JAX dryrun's checks on the per-rank results of `dryrun_jobs`;
    raises AssertionError naming the failed ones."""
    integ, icp_res, ray, rollup, integ_p, ray_p = out[0]
    expect = np.ones(7, np.int32)
    expect[1] = 0
    checks = {
        "tiny n_active > 0": integ["n_active"] > 0,
        "partitioned == replicated": all(r[0]["partitioned_equal"] and r[0]["pad_rows_zero"]
                                         for r in out),
        "same tables on every rank": len({r[0]["digest_tables"] for r in out}) == 1,
        "pair ICP fitness > 0.9": bool((icp_res["sharded"]["fitness"] > 0.9).all()),
        "raycast shape": ray["z"].shape == (n, 32, 40),
        "roll-up merged": all(np.array_equal(r[3], expect) for r in out),
        "production n_active > 0": integ_p["n_active"] > 0,
        "production raycast shape": ray_p["z"].shape == (n, 960, 1280),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dryrun_multichip({n}, {device}, {backend}) failed: {failed}")
    print(f"[dryrun_multichip] ok: {n} {backend} ranks on {device}, {integ['n_active']} "
          f"active blocks; partitioned state + sharded pair-ICP + sharded raycast + "
          f"session roll-up; production shape (50k blocks, 320x288 depth, 1280x960 "
          f"raycast) ran ({integ_p['n_active']} blocks)")


def dryrun_multichip(n: int, device="cuda", backend="nccl", timeout_s: float = 1200.0):
    """Every sharded path on n ranks of this host (`dryrun_jobs`), checked
    as the JAX dryrun checks them; returns rank 0's results.  On one card,
    n > 1 needs backend="gloo" (NCCL refuses two ranks on one GPU)."""
    out = spawn_ranks("mq3d_tpu_torch.parallel.dryrun:rank_run", n, backend, device,
                      dryrun_jobs(n), timeout_s=timeout_s)
    check_dryrun(out, n, device, backend)
    return out[0]


def main(argv=None) -> None:
    """python -m mq3d_tpu_torch.parallel.dryrun [--ranks N] [--device cuda]
    [--backend nccl]: dryrun_multichip on N ranks of this host.  Under
    torchrun (RANK in the environment) each process is one rank of
    torchrun's group instead, and rank 0 checks every rank's results."""
    import argparse
    import os

    import torch.distributed as dist

    from mq3d_tpu_torch.parallel.dist import destroy_group, init_group

    parser = argparse.ArgumentParser(description="Run every sharded path once")
    parser.add_argument("--ranks", type=int, default=2, help="ranks to spawn (not under torchrun)")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("--backend", default="nccl", help="'nccl' (default) or 'gloo'")
    parser.add_argument("--timeout-s", type=float, default=1200.0)
    args = parser.parse_args(argv)
    if "RANK" not in os.environ:
        dryrun_multichip(args.ranks, args.device, args.backend, args.timeout_s)
        return
    group = init_group(args.backend, timeout_s=args.timeout_s)
    try:
        device = torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        n = world_of(group)
        mine = rank_run(group, device, dryrun_jobs(n))
        out = [None] * n
        dist.all_gather_object(out, mine, group=group)
        if rank_of(group) == 0:
            check_dryrun(out, n, device, args.backend)
    finally:
        destroy_group()


if __name__ == "__main__":
    main()
