"""Multi-view depth-consistency confidence maps (reconstruction step 1).

Counterpart of mq3d_tpu/recon/confidence.py: each reference frame's depth
is unprojected to world, reprojected into each of its +-target_frame_range
neighbour frames, bilinearly compared against the neighbour's depth, and
the per-pixel 3D error is thresholded into consistent / valid counts.

One batched tensor pass covers a block of reference frames and all of
their neighbours at once, as (refs, neighbours, H, W) arrays; invalid
pixels ride along masked.  The arithmetic follows XLA's CPU code: the
pose transforms are its fused multiply-add chains (`ops.tsdf._apply_pose`)
and the bilinear blend one more chain, so the counts equal the JAX
package's on nearly every pixel (tests/test_torch_confidence.py states the
share).

Under a profiler a call is the range "confidence.call", its phases the
ranges "confidence.inputs", ".project", ".sample", ".error" and ".count"
in that order, and each `_fma` inside them the range "fma"
(`utils.log.span`); step 1's read-back and writes are "confidence.readback"
and "confidence.save".
"""

from __future__ import annotations

import numpy as np
import torch

from mq3d_tpu_torch.config.configs import DepthConfidenceEstimationConfig
from mq3d_tpu_torch.dataio.depth_io import DepthDataIO
from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.models.camera import ConfidenceMap
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops.tsdf import _apply_pose, _fma, _norm3, _to_i32
from mq3d_tpu_torch.utils.log import span


def _bilinear_depth(depth, u, v, depth_max: float):
    """Bilinear depth sample of `depth` (..., H, W) at (u, v) (..., H, W),
    valid only where all four taps are valid depths.  Returns (z, valid)."""
    h, w = depth.shape[-2:]
    u0 = _to_i32(torch.floor(u))
    v0 = _to_i32(torch.floor(v))
    u1 = u0 + 1
    v1 = v0 + 1
    inb = (u0 >= 0) & (u1 < w) & (v0 >= 0) & (v1 < h)
    flat = depth.reshape(depth.shape[:-2] + (h * w,))

    def tap(vv, uu):
        idx = (vv.clamp(0, h - 1) * w + uu.clamp(0, w - 1)).long()
        return torch.gather(flat, -1, idx.reshape(idx.shape[:-2] + (-1,))).reshape(idx.shape)

    Ia, Ib, Ic, Id = tap(v0, u0), tap(v0, u1), tap(v1, u0), tap(v1, u1)
    taps_ok = ((Ia > 0) & (Ia <= depth_max) & (Ib > 0) & (Ib <= depth_max)
               & (Ic > 0) & (Ic <= depth_max) & (Id > 0) & (Id <= depth_max))
    wa = (u1 - u) * (v1 - v)
    wb = (u - u0) * (v1 - v)
    wc = (u1 - u) * (v - v0)
    wd = (u - u0) * (v - v0)
    z = _fma(wd, Id, _fma(wc, Ic, _fma(wb, Ib, wa * Ia)))
    return z, inb & taps_ok


def _pair_error(ref_depth, tgt_depth, K_ref, K_tgt, T_ref_cw, T_tgt_wc, T_tgt_cw,
                depth_max: float):
    """Per-pixel 3D error of reference depth against target frames.

    ref_depth (..., H, W), tgt_depth (..., H, W); K_* (..., 3, 3) and T_*
    (..., 4, 4), all broadcasting over the leading dimensions.  Returns
    (err (..., H, W) float32, valid (..., H, W) bool), `valid` where the
    reference's error map is not NaN."""
    h, w = ref_depth.shape[-2:]
    dev = ref_depth.device

    def cam(K, i, j):
        return K[..., i, j][..., None, None]

    def pose(T):
        return T[..., None, None, :, :]

    fx_r, fy_r, cx_r, cy_r = cam(K_ref, 0, 0), cam(K_ref, 1, 1), cam(K_ref, 0, 2), cam(K_ref, 1, 2)
    fx_t, fy_t, cx_t, cy_t = cam(K_tgt, 0, 0), cam(K_tgt, 1, 1), cam(K_tgt, 0, 2), cam(K_tgt, 1, 2)

    # Reference pixel -> world -> target camera.
    with span("confidence.project"):
        u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        z = ref_depth
        px_valid = (z > 0) & (z <= depth_max)
        x = (u - cx_r) * z / fx_r
        y = (v - cy_r) * z / fy_r
        p_world = _apply_pose(torch.stack([x, y, z], dim=-1), pose(T_ref_cw))
        p_tgt = _apply_pose(p_world, pose(T_tgt_wc))
        zt = p_tgt[..., 2]
        proj_ok = px_valid & (zt > 0) & (zt <= depth_max)
        zt_safe = torch.where(zt > 0, zt, torch.ones_like(zt))
        ut = p_tgt[..., 0] * fx_t / zt_safe + cx_t
        vt = p_tgt[..., 1] * fy_t / zt_safe + cy_t

    with span("confidence.sample"):
        z_tgt, samp_ok = _bilinear_depth(tgt_depth, ut, vt, depth_max)
        samp_ok &= z_tgt > 0

    # The sampled target depth back to world, and the distance.
    with span("confidence.error"):
        xt = (ut - cx_t) * z_tgt / fx_t
        yt = (vt - cy_t) * z_tgt / fy_t
        q_world = _apply_pose(torch.stack([xt, yt, z_tgt], dim=-1), pose(T_tgt_cw))
        err = _norm3(p_world - q_world)
    return err, proj_ok & samp_ok


def confidence_for_refs(depth_stack, K, T_cw, T_wc, frame_valid, ref_indices,
                        depth_max: float, error_threshold: float, window: int):
    """Confidence maps for a block of reference frames, in one pass.

    depth_stack (N, H, W) float32, K (N, 3, 3), T_cw and T_wc (N, 4, 4)
    float32, frame_valid (N,) bool and ref_indices (B,) int, all tensors on
    one device.  Each reference counts over the neighbours in
    [ref - window, ref + window] except itself.  Returns (confidence
    (B, H, W) float32, valid_count (B, H, W) int64)."""
    with span("confidence.call"):
        n = depth_stack.shape[0]
        dev = depth_stack.device
        with span("confidence.inputs"):
            ref = ref_indices.long()
            offsets = torch.cat([torch.arange(-window, 0), torch.arange(1, window + 1)]).to(dev)
            tgt = ref[:, None] + offsets[None, :]  # (B, 2 * window)
            in_range = (tgt >= 0) & (tgt < n)
            tgt_c = tgt.clamp(0, n - 1)
            inputs = (depth_stack[ref][:, None], depth_stack[tgt_c], K[ref][:, None], K[tgt_c],
                      T_cw[ref][:, None], T_wc[tgt_c], T_cw[tgt_c])

        err, ok = _pair_error(*inputs, depth_max)
        with span("confidence.count"):
            ok &= (in_range & frame_valid[tgt_c] & frame_valid[ref][:, None])[..., None, None]
            consistent = ok & (err <= error_threshold)
            # int64 counts, divided in float64: the JAX package's types (x64
            # mode), which its per-frame npz files store.
            valid_count = ok.sum(dim=1)
            n_consistent = consistent.sum(dim=1)
            conf = torch.where(valid_count > 0,
                               n_consistent.double() / valid_count.clamp(min=1).double(),
                               torch.zeros((), dtype=torch.float64, device=dev)).float()
        return conf, valid_count


def estimate_depth_confidences(depth_data_io: DepthDataIO,
                               config: DepthConfidenceEstimationConfig,
                               device="cuda") -> None:
    """Step 1 for both sides on `device`: one confidence npz per valid frame
    (confidence_map, valid_count, as the reference writes them), frames
    with a map already skipped, and the packed stack for integration
    streamed from the results when every frame is computed afresh."""
    dev = resolve_device(device)
    for side in Side:
        if config.skip_if_output_dir_exists and depth_data_io.exists_depth_confidence_map_dir(side):
            print(f"[{side.name}] Skipping confidence estimation: output dir exists.")
            continue

        dataset = depth_data_io.load_depth_dataset(side=side)
        n = len(dataset)
        if n == 0:
            continue

        K = dataset.get_render_intrinsic_matrices().astype(np.float32)
        transforms = dataset.transforms.convert_coordinate_system(
            CoordinateSystem.OPEN3D, is_camera=True)
        T_cw = transforms.extrinsics_cw.astype(np.float32)
        T_wc = np.linalg.inv(T_cw)

        todo = [i for i in range(n)
                if depth_data_io.load_confidence_map(side, int(dataset.timestamps[i])) is None]
        if not todo:
            # The integration reads the per-frame maps when there is no pack.
            print(f"[{side.name}] All confidence maps cached.")
            continue

        depth_stack, frame_valid = depth_data_io.load_depth_stack(side, dataset)
        # The whole sequence goes to the device once; batches pick indices.
        depth_dev = torch.from_numpy(depth_stack).to(dev)
        K_dev, T_cw_dev, T_wc_dev = (torch.from_numpy(a).to(dev) for a in (K, T_cw, T_wc))
        valid_dev = torch.from_numpy(frame_valid).to(dev)

        # The pack is streamed only when every frame is computed here, so it
        # is complete.  Its rows are the frames that get a map: an invalid
        # frame stays absent (the integration then warns for it).
        writer = None
        pack_row = None
        if len(todo) == n and frame_valid.any():
            h, w = depth_stack.shape[1:]
            ts_valid = np.asarray(dataset.timestamps, np.int64)[frame_valid]
            pack_row = np.cumsum(frame_valid) - 1
            writer = depth_data_io.start_confidence_pack(
                side, ts_valid, (h, w), np.float32, (h, w), np.int32)

        B = max(1, int(config.frames_per_batch))
        print(f"[{side.name}] Estimating depth confidence maps: {len(todo)} frames, "
              f"{B} per batch")
        for s in range(0, len(todo), B):
            batch = todo[s:s + B]
            # The last batch is padded with its last frame, as in the JAX
            # package, so every pass has the same shape.
            refs = np.asarray(batch + [batch[-1]] * (B - len(batch)), np.int64)
            conf, cnt = confidence_for_refs(
                depth_dev, K_dev, T_cw_dev, T_wc_dev, valid_dev,
                torch.from_numpy(refs).to(dev),
                depth_max=float(config.depth_max),
                error_threshold=float(config.error_threshold),
                window=int(config.target_frame_range))
            with span("confidence.readback"):
                conf = conf.cpu().numpy()
                cnt = cnt.cpu().numpy()
            with span("confidence.save"):
                for bi, i in enumerate(batch):
                    if not frame_valid[i]:
                        continue
                    depth_data_io.save_confidence_map(
                        side, int(dataset.timestamps[i]),
                        ConfidenceMap(confidence_map=conf[bi], valid_count=cnt[bi]))
                    if writer is not None:
                        writer.write(int(pack_row[i]), conf[bi], cnt[bi].astype(np.int32))
        if writer is not None:
            # After the per-frame saves, each of which removes the pack.
            with span("confidence.save"):
                writer.finalize()
