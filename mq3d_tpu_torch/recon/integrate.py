"""TSDF integration: dataset -> volume, chunked device passes.

Counterpart of mq3d_tpu/recon/integrate.py.  Depth stacks are loaded and
confidence-filtered on the host, then integrated chunk by chunk on the
volume's device.  Chunk boundaries are the JAX build's (frames_per_batch
frames, spanning the LEFT/RIGHT boundary in integrate_multi), because
chunking changes the float rounding of the merge: same chunks, same bits.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np

from mq3d_tpu_torch.config.configs import IntegrationConfig
from mq3d_tpu_torch.dataio.depth_io import DepthDataIO
from mq3d_tpu_torch.models.datasets import DepthDataset
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.ops.tsdf import (
    TSDFConfig,
    TSDFVolume,
    create_state,
    fresh_integrate_extract,
)


def load_filtered_depth_stack(
    depth_data_io: DepthDataIO,
    side: Side,
    dataset: DepthDataset,
    indices: np.ndarray,
    use_confidence_filtered_depth: bool,
    confidence_threshold: float,
    valid_count_threshold: int,
):
    """(N, H, W) linear depth stack with confidence filtering applied
    (pixels below the confidence or valid-count threshold are zeroed)."""
    stack, valid = depth_data_io.load_depth_stack(side, dataset, indices)
    if use_confidence_filtered_depth:
        ts = np.asarray(dataset.timestamps)[np.asarray(indices, np.int64)]
        conf, cnt, have = depth_data_io.load_confidence_stack(side, ts)
        for t in ts[valid & ~have]:
            print(f"[Warning] Confidence map not found for timestamp {t}")
        sel = valid & have
        if sel.any() and conf.shape[1:] == stack.shape[1:]:
            kill = (conf < confidence_threshold) | (cnt < valid_count_threshold)
            kill &= sel[:, None, None]
            stack[kill] = 0.0
        elif sel.any():
            print(
                f"[Warning] Confidence map shape {conf.shape[1:]} does not "
                f"match depth {stack.shape[1:]}; skipping confidence filter"
            )
    return stack, valid


def tsdf_config_from_integration(config: IntegrationConfig) -> TSDFConfig:
    """Duck-typed: also accepts FragmentPoseRefinementConfig (same fields).
    Knobs absent from `config` take the TSDFConfig defaults."""
    return TSDFConfig(
        voxel_size=config.voxel_size,
        block_resolution=config.block_resolution,
        block_count=config.block_count,
        depth_max=config.depth_max,
        trunc_voxel_multiplier=config.trunc_voxel_multiplier,
        alloc_pixel_stride=int(getattr(config, "alloc_pixel_stride", 2)),
        grid_dim=int(getattr(config, "grid_dim", 160)),
        chunk_active_capacity=int(getattr(config, "chunk_active_capacity", 12_288)),
        integrate_tile=int(getattr(config, "integrate_tile", 512)),
    )


def _chunk_size(config) -> int:
    return max(1, int(getattr(config, "frames_per_batch", 16)))


def integrate(
    dataset: DepthDataset,
    depth_data_io: DepthDataIO,
    side: Side,
    config: IntegrationConfig,
    vbg_opt: Optional[TSDFVolume] = None,
    device="cuda",
) -> TSDFVolume:
    """Integrate every frame of `dataset` into a (possibly shared) volume.

    Dataset transforms must already be in the OPEN3D camera frame.
    Exhausting the block pool grows it and replays the dataset (see
    _integrate_with_growth); no observations are lost."""
    vol = vbg_opt if vbg_opt is not None else TSDFVolume(
        tsdf_config_from_integration(config), device=device)
    n = len(dataset)
    if n == 0:
        return vol

    K = dataset.get_render_intrinsic_matrices().astype(np.float32)
    T_wc = dataset.transforms.extrinsics_wc.astype(np.float32)
    chunk = _chunk_size(config)

    def run_all(v: TSDFVolume) -> None:
        for s in range(0, n, chunk):
            idx = np.arange(s, min(s + chunk, n))
            stack, valid = load_filtered_depth_stack(
                depth_data_io, side, dataset, idx,
                config.use_confidence_filtered_depth,
                config.confidence_threshold,
                config.valid_count_threshold,
            )
            if valid.any():
                v.integrate(stack, K[idx], T_wc[idx], valid)

    _integrate_with_growth(vol, run_all, entry_empty=_volume_is_empty(vol))
    return vol


def _volume_is_empty(vol: TSDFVolume) -> bool:
    """True when the volume holds no prior content (safe to rebuild from
    scratch on block-pool overflow)."""
    return vol.state.n_active == 0 and vol.state.overflow == 0


# Doubling the block pool more than this many times means the workload is
# ~10x the configured capacity: treat it as misconfiguration, keep the data
# we have, and warn.
_MAX_POOL_GROWTHS = 3


def _integrate_with_growth(vol: TSDFVolume, run_all, entry_empty: bool) -> None:
    """Run `run_all(vol)`; when the block pool overflows, grow it (2x) in
    place and replay from an empty volume until every allocation fits
    (Open3D's hash map grows transparently).  A volume that held content
    at entry cannot be replayed, so its overflow only warns."""
    for _ in range(_MAX_POOL_GROWTHS + 1):
        run_all(vol)
        overflow = vol.state.overflow
        if overflow == 0 or not entry_empty:
            break
        new_count = vol.cfg.block_count * 2
        print(
            f"[Info] TSDF block pool exhausted ({overflow} allocations "
            f"dropped at block_count={vol.cfg.block_count}); growing to "
            f"{new_count} and re-integrating"
        )
        device = vol.device
        vol.state = None  # release the old pool before allocating the new
        vol.cfg = replace(vol.cfg, block_count=new_count)
        vol.state = create_state(vol.cfg, device)
    _warn_volume_overflow(vol)


def _warn_volume_overflow(vol: TSDFVolume) -> None:
    if vol.state.overflow > 0:
        print(
            f"[Warning] TSDF block capacity exceeded: {vol.state.overflow} "
            f"allocations dropped (block_count={vol.cfg.block_count})"
        )
    if vol.state.dropped_active > 0:
        print(
            f"[Warning] TSDF chunk active-block capacity exceeded: "
            f"{vol.state.dropped_active} block-chunk integrations skipped "
            f"(chunk_active_capacity={vol.cfg.chunk_active_capacity}; raise it "
            f"or reduce the chunk size; depth observations were dropped)"
        )


def _load_sides(dataset_map, depth_data_io, config, parts):
    """One (n, H, W) stack + valid + K + T_wc for `parts`, a list of
    (side, frame index) in order."""
    stacks, valids, Kc, Tc = [], [], [], []
    j = 0
    while j < len(parts):
        s = parts[j][0]
        k = j
        while k < len(parts) and parts[k][0] == s:
            k += 1
        idx = np.asarray([i for _, i in parts[j:k]])
        ds = dataset_map[s]
        st, va = load_filtered_depth_stack(
            depth_data_io, s, ds, idx,
            config.use_confidence_filtered_depth,
            config.confidence_threshold,
            config.valid_count_threshold,
        )
        stacks.append(st)
        valids.append(va)
        Kc.append(ds.get_render_intrinsic_matrices().astype(np.float32)[idx])
        Tc.append(ds.transforms.extrinsics_wc.astype(np.float32)[idx])
        j = k
    return (np.concatenate(stacks), np.concatenate(valids),
            np.concatenate(Kc), np.concatenate(Tc))


def _uniform_sides(dataset_map):
    sides = [s for s, ds in dataset_map.items() if len(ds) > 0]
    shapes = {(int(dataset_map[s].heights[0]), int(dataset_map[s].widths[0]))
              for s in sides}
    return sides, len(shapes) <= 1


def integrate_extract_small(
    dataset_map,
    depth_data_io: DepthDataIO,
    config: IntegrationConfig,
    weight_threshold: float = 3.0,
    device="cuda",
):
    """Captures that fit a single chunk: both sides' frames in ONE chunk,
    then point extraction.  Returns (volume, point_cloud), accumulation-
    identical to the JAX build's fused one-launch program, or None when the
    capture spans several chunks, the sides' resolutions differ, or no frame
    is valid (the caller then takes integrate_multi)."""
    sides, uniform = _uniform_sides(dataset_map)
    if not sides or not uniform:
        return None
    parts = [(s, i) for s in sides for i in range(len(dataset_map[s]))]
    if len(parts) > _chunk_size(config):
        return None
    stack, valid, K, T = _load_sides(dataset_map, depth_data_io, config, parts)
    if not valid.any():
        return None

    cfg_t = tsdf_config_from_integration(config)
    for _ in range(_MAX_POOL_GROWTHS + 1):
        vol, pcd, overflow = fresh_integrate_extract(
            cfg_t, stack, K, T, valid, weight_threshold, device=device)
        if overflow == 0:
            break
        new_count = cfg_t.block_count * 2
        print(
            f"[Info] TSDF block pool exhausted ({overflow} allocations "
            f"dropped at block_count={cfg_t.block_count}); growing to "
            f"{new_count} and re-integrating"
        )
        del vol, pcd
        cfg_t = replace(cfg_t, block_count=new_count)
    _warn_volume_overflow(vol)
    return vol, pcd


def integrate_multi(
    dataset_map,
    depth_data_io: DepthDataIO,
    config: IntegrationConfig,
    vbg_opt: Optional[TSDFVolume] = None,
    device="cuda",
) -> TSDFVolume:
    """Integrate every frame of every side into ONE volume, with chunks that
    span the side boundary (the JAX build's chunking, so the same bits).
    Sides of different depth resolution integrate one after another."""
    sides, uniform = _uniform_sides(dataset_map)
    if not sides:
        return vbg_opt if vbg_opt is not None else TSDFVolume(
            tsdf_config_from_integration(config), device=device)
    if not uniform:
        vol = vbg_opt
        for s in sides:
            vol = integrate(dataset=dataset_map[s], depth_data_io=depth_data_io,
                            side=s, config=config, vbg_opt=vol, device=device)
        return vol

    vol = vbg_opt if vbg_opt is not None else TSDFVolume(
        tsdf_config_from_integration(config), device=device)
    seq = [(s, i) for s in sides for i in range(len(dataset_map[s]))]
    chunk = _chunk_size(config)

    def run_all(v: TSDFVolume) -> None:
        for c0 in range(0, len(seq), chunk):
            stack, valid, K, T = _load_sides(
                dataset_map, depth_data_io, config, seq[c0:c0 + chunk])
            if valid.any():
                v.integrate(stack, K, T, valid)

    _integrate_with_growth(vol, run_all, entry_empty=_volume_is_empty(vol))
    return vol
