"""The check of step 1's maps: plain multi-view depth consistency, computed
again from the session's depth frames and poses.

For a reference frame r and each neighbour t within `target_frame_range`
frames of it on the same side (t != r), every pixel of r with a depth in
(0, depth_max] is unprojected to the world, projected into t, and t's
depth there is sampled bilinearly (all four taps in (0, depth_max]); the
sampled point goes back to the world, and the pair is consistent where the
two world points lie within `error_threshold`.  valid_count is the number
of neighbours for which all of that held; confidence is the consistent
share of them (0 without any).

The program's maps are checked on a sample of its calls drawn from the
seed (`checked_batches`): a quarter of each side's batches, always with
the side's last, padded batch.  Two shares are compared over the sampled
reference frames, each against its limit: `count_mismatch_share`, the
pixels whose valid_count differs from the program's, and
`conf_mismatch_share`, the pixels whose confidence differs by more than
CONF_TOL.  A projection that rounds onto another pixel's tap, or an error
on the threshold, moves a few pixels; a wrong pose, neighbour or depth
moves many.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core import setting

# Confidences are ratios of small counts: different ones differ by 1/20
# or more, equal ones by rounding of the division only.
CONF_TOL = 1e-6
CHECKED_SHARE = 0.25  # of each side's batches
REFS_PER_CALL = "reconstruction.confidence_estimation.frames_per_batch"


def refs_per_call(config: dict) -> int:
    return max(1, int(setting(config, REFS_PER_CALL)))


def checked_batches(n_sides: int, frames_per_side: int, refs: int, seed: int) -> list:
    """(side, first reference) of the calls whose maps are checked, drawn
    from the seed: per side, the last call and others up to CHECKED_SHARE
    of the side's calls."""
    rng = np.random.default_rng([int(seed), 0xC0F])
    starts = list(range(0, frames_per_side, refs))
    k = max(1, int(np.ceil(CHECKED_SHARE * len(starts))))
    out = []
    for s in range(n_sides):
        pick = rng.choice(len(starts) - 1, size=min(k, len(starts)) - 1, replace=False)
        out += [(s, starts[i]) for i in sorted(pick.tolist())] + [(s, starts[-1])]
    return out


def _mul_add_pose(R, t, x, y, z):
    """R @ (x, y, z) + t, summed left to right."""
    return [R[..., i, 0] * x + R[..., i, 1] * y + R[..., i, 2] * z + t[..., i]
            for i in range(3)]


def side_maps(depth, K, T_cw, T_wc, refs, depth_max: float, error_threshold: float,
              window: int, dtype=torch.float32):
    """(confidence (B, H, W) float32, valid_count (B, H, W) int64) of
    reference frames `refs` of one side's stack `depth` (N, H, W)."""
    N, H, W = depth.shape
    dev = depth.device
    z, Kd, Tcw, Twc = depth.to(dtype), K.to(dtype), T_cw.to(dtype), T_wc.to(dtype)
    u = torch.arange(W, device=dev).to(dtype)[None, :]
    v = torch.arange(H, device=dev).to(dtype)[:, None]
    count = torch.zeros((len(refs), H, W), dtype=torch.int64, device=dev)
    consistent = torch.zeros_like(count)
    for off in [o for o in range(-window, window + 1) if o != 0]:
        tgt = refs + off
        inside = (tgt >= 0) & (tgt < N)
        r = refs[inside]
        t = tgt[inside]
        zr = z[r]
        Kr, Kt = Kd[r][:, :, :, None, None], Kd[t][:, :, :, None, None]
        x = (u - Kr[:, 0, 2]) * zr / Kr[:, 0, 0]
        y = (v - Kr[:, 1, 2]) * zr / Kr[:, 1, 1]
        pw = _mul_add_pose(Tcw[r][:, None, None], Tcw[r][:, :3, 3][:, None, None], x, y, zr)
        pt = _mul_add_pose(Twc[t][:, None, None], Twc[t][:, :3, 3][:, None, None], *pw)
        zt = pt[2]
        ok = (zr > 0) & (zr <= depth_max) & (zt > 0) & (zt <= depth_max)
        zs = torch.where(zt > 0, zt, torch.ones((), dtype=dtype, device=dev))
        ut = pt[0] * Kt[:, 0, 0] / zs + Kt[:, 0, 2]
        vt = pt[1] * Kt[:, 1, 1] / zs + Kt[:, 1, 2]
        u0, v0 = torch.floor(ut), torch.floor(vt)
        ok &= (u0 >= 0) & (u0 + 1 < W) & (v0 >= 0) & (v0 + 1 < H)
        iu = u0.clamp(0, W - 2).long()
        iv = v0.clamp(0, H - 2).long()
        base = (t[:, None, None] * H + iv) * W + iu
        flat = z.reshape(-1)
        taps = [flat[base], flat[base + 1], flat[base + W], flat[base + W + 1]]
        for tap in taps:
            ok &= (tap > 0) & (tap <= depth_max)
        fu, fv = ut - u0, vt - v0
        zq = ((1 - fu) * (1 - fv) * taps[0] + fu * (1 - fv) * taps[1]
              + (1 - fu) * fv * taps[2] + fu * fv * taps[3])
        ok &= zq > 0
        xq = (ut - Kt[:, 0, 2]) * zq / Kt[:, 0, 0]
        yq = (vt - Kt[:, 1, 2]) * zq / Kt[:, 1, 1]
        qw = _mul_add_pose(Tcw[t][:, None, None], Tcw[t][:, :3, 3][:, None, None], xq, yq, zq)
        err = torch.sqrt(sum((a - b) ** 2 for a, b in zip(pw, qw)))
        rows = torch.nonzero(inside).squeeze(1)
        count[rows] += ok.long()
        consistent[rows] += (ok & (err <= error_threshold)).long()
    conf = torch.where(count > 0, consistent.double() / count.clamp(min=1).double(),
                       torch.zeros((), dtype=torch.float64, device=dev)).float()
    return conf, count


def maps(session, config, frames, device, dtype=torch.float32):
    """(confidence (F, H, W), valid_count (F, H, W)) as numpy arrays, of the
    reference frames `frames`: (side, [reference, ...]) groups, each
    computed in one call."""
    ce = config["reconstruction"]["confidence_estimation"]
    args = dict(depth_max=float(ce["depth_max"]), error_threshold=float(ce["error_threshold"]),
                window=int(ce["target_frame_range"]), dtype=dtype)
    confs, counts, inputs = [], [], {}
    for s, refs in frames:
        if s not in inputs:
            sl = session.side_slice(s)
            T_cw = torch.from_numpy(session.T_cw[sl]).to(device)
            inputs[s] = (session.depth[sl].to(device),
                         torch.from_numpy(np.asarray(session.K_depth[sl], np.float64)).to(device),
                         T_cw, torch.linalg.inv(T_cw))
        c, n = side_maps(*inputs[s], torch.as_tensor(refs, device=device), **args)
        confs.append(c.cpu().numpy())
        counts.append(n.cpu().numpy())
    return np.concatenate(confs), np.concatenate(counts)


def compare(conf, count, ref_conf, ref_count) -> dict:
    n = ref_count.size
    return {
        "count_mismatch_share": float(np.count_nonzero(count != ref_count)) / n,
        "conf_mismatch_share": float(np.count_nonzero(np.abs(conf - ref_conf) > CONF_TOL)) / n,
    }


def check(session, config, outputs, device, seed: int) -> dict:
    """The program's maps of the checked calls (`outputs`: "frames" as
    `maps` takes them, "confidence" and "valid_count" stacked in that
    order) against the reference's."""
    ref_conf, ref_count = maps(session, config, outputs["frames"], device)
    return compare(outputs["confidence"], outputs["valid_count"], ref_conf, ref_count)


def control(session, config, device, seed: int) -> dict:
    """The reference in bfloat16, put in the program's place, on the calls
    a run with this seed checks."""
    n, B = session.frames_per_side, refs_per_call(config)
    frames = [(s, list(range(b, min(b + B, n))))
              for s, b in checked_batches(int(session.side.max()) + 1, n, B, seed)]
    ref_conf, ref_count = maps(session, config, frames, device)
    low_conf, low_count = maps(session, config, frames, device, dtype=torch.bfloat16)
    return compare(low_conf, low_count, ref_conf, ref_count)
