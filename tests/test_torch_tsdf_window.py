"""Phase B's dispatch between K5 (one launch a capacity window) and the tile
loop, and K5's wrapper, on the CPU.

`ops.tsdf._resolve_lookup` gives K5 ("window") only for depth_lookup
"auto" on a card; CPU tensors and the explicit modes keep the tile loop,
which is K5's reference.  K5's wrapper (`ops.tsdf_window.integrate_window`)
refuses CPU tensors and wrong dtypes or shapes before it builds or launches
anything.  The kernel itself is held against the tile loop bit for bit on
the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops import tsdf
from mq3d_tpu_torch.ops import tsdf_window
from mq3d_tpu_torch.testing.synthetic import (
    SyntheticSceneConfig, intrinsics_from_cfg, orbit_poses_o3d, render_box_depth)

torch.set_num_threads(1)

CFG = dict(voxel_size=0.04, block_resolution=8, block_count=2048, grid_dim=32,
           depth_max=4.0, trunc_voxel_multiplier=4.0, chunk_active_capacity=2048,
           integrate_tile=64, onehot_patch=32)


@pytest.mark.parametrize("mode,device,want", [
    ("auto", "cuda", "window"),
    ("auto", "cpu", "flat"),
    ("flat", "cuda", "flat"),
    ("onehot", "cuda", "onehot"),
    ("pallas", "cuda", "pallas"),
    ("pallas", "cpu", "pallas"),
    ("flat", "cpu", "flat"),
])
def test_resolve_lookup_gives_k5_only_for_auto_on_a_card(mode, device, want):
    cfg = tsdf.TSDFConfig(depth_lookup=mode)
    assert tsdf._resolve_lookup(cfg, torch.device(device)) == want


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_window_is_no_configuration_value(device):
    """K5 adds no knob: "window" is what "auto" resolves to, not a mode."""
    with pytest.raises(ValueError, match="unknown depth_lookup"):
        tsdf._resolve_lookup(tsdf.TSDFConfig(depth_lookup="window"), torch.device(device))


def _chunk(n=6, h=72, w=96):
    scene = SyntheticSceneConfig(n_frames=n, depth_width=w, depth_height=h)
    fx, fy, cx, cy = intrinsics_from_cfg(scene, w, h)
    poses_cw = orbit_poses_o3d(scene).extrinsics_cw.astype(np.float64)
    depth = np.stack([render_box_depth(p, fx, fy, w - cx, cy, w, h, scene.box_min,
                                       scene.box_max) for p in poses_cw]).astype(np.float32)
    K = np.tile(np.array([[fx, 0, w - cx], [0, fy, cy], [0, 0, 1]], np.float32), (n, 1, 1))
    T = np.linalg.inv(poses_cw).astype(np.float32)
    return [torch.from_numpy(a) for a in (depth, K, T, np.ones(n, bool))]


@pytest.mark.parametrize("mode", ["auto", "flat", "onehot", "pallas"])
def test_cpu_tensors_keep_the_tile_loop(monkeypatch, mode):
    """Every mode on CPU tensors integrates through the tile loop and never
    calls K5's wrapper; the volume is the same in every mode."""
    tiles = []
    real = tsdf._integrate_pairs
    monkeypatch.setattr(tsdf, "_integrate_pairs", lambda *a: tiles.append(1) or real(*a))
    monkeypatch.setattr(tsdf, "integrate_window",
                        lambda *a: pytest.fail("K5's wrapper called for CPU tensors"))
    cfg = tsdf.TSDFConfig(depth_lookup=mode, **CFG)
    state = tsdf.create_state(cfg, "cpu")
    tsdf.integrate_chunk(cfg, state, *_chunk())
    assert tiles and state.n_active > 0
    want = tsdf.create_state(tsdf.TSDFConfig(depth_lookup="flat", **CFG), "cpu")
    tsdf.integrate_chunk(tsdf.TSDFConfig(depth_lookup="flat", **CFG), want, *_chunk())
    got, ref = tsdf.state_to_numpy(state), tsdf.state_to_numpy(want)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_window_path_hands_k5_the_window_and_skips_the_tile_loop(monkeypatch):
    """Where Phase B resolves to K5, integrate_chunk hands it the chunk, its
    touch grid and the window Phase A chose, once a window, and makes no
    pair list, tile or merge of its own."""
    calls = []
    monkeypatch.setattr(tsdf, "_resolve_lookup", lambda cfg, dev: "window")
    for name in ("_pairs_from_grid", "_integrate_pairs", "_merge_window"):
        monkeypatch.setattr(tsdf, name, lambda *a, _n=name: pytest.fail(f"{_n} called"))
    monkeypatch.setattr(tsdf, "integrate_window", lambda *a: calls.append(a))
    cfg = tsdf.TSDFConfig(**dict(CFG, chunk_active_capacity=100))
    state = tsdf.create_state(cfg, "cpu")
    depth, K, T, valid = _chunk()
    tsdf.integrate_windows(cfg, state, lambda skip: tsdf.integrate_chunk(
        cfg, state, depth, K, T, valid, skip))
    n_windows = -(-state.n_active // 100)
    assert state.n_active > 100 and len(calls) == n_windows
    keys = torch.nonzero(state.slot_table >= 0).squeeze(1)
    for i, (c, ts, wt, bc, d, k, e, touched, wkeys, slots) in enumerate(calls):
        assert c is cfg and ts is state.tsdf and wt is state.weight
        assert bc is state.block_coords and d is depth and k is K and e is T
        assert touched.shape == (len(depth), cfg.grid_dim ** 3 + 1)
        assert torch.equal(wkeys, keys[i * 100:(i + 1) * 100])
        assert torch.equal(slots, state.slot_table[wkeys].long())
    assert state.dropped_active == 0


def _window_args(device="cpu"):
    """Valid K5 operands for a 2-frame chunk of 8x10 depth, a window of 3
    blocks of 4^3 voxels, on `device`."""
    C, H, W, R, N, G = 2, 8, 10, 4, 5, 64
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        tsdf=torch.zeros((N, R ** 3), **f32), weight=torch.zeros((N, R ** 3), **f32),
        block_coords=torch.zeros((N, 3), dtype=torch.int32, device=device),
        depth=torch.ones((C, H, W), **f32), intrinsics=torch.eye(3, **f32).expand(C, 3, 3),
        extrinsics_wc=torch.eye(4, **f32).expand(C, 4, 4),
        frame_touched=torch.zeros((C, G + 1), dtype=torch.bool, device=device),
        wkeys=torch.arange(3, device=device), slots=torch.arange(3, device=device))


_BAD = [
    ("tsdf", lambda a: a["tsdf"].double(), TypeError, "tsdf must be torch.float32"),
    ("weight", lambda a: a["weight"].half(), TypeError, "weight must be"),
    ("block_coords", lambda a: a["block_coords"].long(), TypeError, "block_coords must be"),
    ("depth", lambda a: a["depth"].double(), TypeError, "depth must be"),
    ("frame_touched", lambda a: a["frame_touched"].to(torch.uint8), TypeError,
     "frame_touched must be"),
    ("wkeys", lambda a: a["wkeys"].int(), TypeError, "wkeys must be"),
    ("slots", lambda a: a["slots"].float(), TypeError, "slots must be"),
    ("depth", lambda a: a["depth"][0], ValueError, r"depth must be \(C, H, W\)"),
    ("tsdf", lambda a: a["tsdf"][:, :10], ValueError, "tsdf must be"),
    ("block_coords", lambda a: a["block_coords"][:, :2], ValueError, "block_coords must be"),
    ("block_coords", lambda a: a["block_coords"][:4], ValueError, "tsdf must be"),
    ("intrinsics", lambda a: a["intrinsics"][:1], ValueError, "intrinsics must be"),
    ("extrinsics_wc", lambda a: a["extrinsics_wc"][:, :3], ValueError, "extrinsics_wc must be"),
    ("frame_touched", lambda a: a["frame_touched"][:1], ValueError, "frame_touched must be"),
    ("slots", lambda a: a["slots"][:2], ValueError, "wkeys and slots"),
    ("weight", lambda a: a["weight"].t().contiguous().t(), ValueError, "contiguous"),
    ("depth", lambda a: np.ones((2, 8, 10), np.float32), TypeError, "depth must be a tensor"),
    (None, lambda a: None, ValueError, "K5 takes CUDA tensors"),
]


@pytest.mark.parametrize("name,bad,exc,match", _BAD,
                         ids=[f"{i}-{b[0]}" for i, b in enumerate(_BAD)])
def test_k5_wrapper_refuses_before_any_launch(monkeypatch, name, bad, exc, match):
    """CPU tensors, a wrong dtype or shape or a non-contiguous table raise
    before the library is built or a launch is counted."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the library was loaded"))
    _build.reset_launch_counts()
    args = _window_args()
    if name is not None:
        args[name] = bad(args)
    with pytest.raises(exc, match=match):
        tsdf_window.integrate_window(tsdf.TSDFConfig(**dict(CFG, block_resolution=4)),
                                     **args)
    assert _build.launch_counts()["tsdf_window"] == 0


def test_k5_wrapper_refuses_mixed_devices(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the library was loaded"))
    args = _window_args()
    args["depth"] = args["depth"].to("meta")
    with pytest.raises(ValueError, match="one card"):
        tsdf_window.integrate_window(tsdf.TSDFConfig(**dict(CFG, block_resolution=4)),
                                     **args)


def test_pair_counts_read_zero_before_any_launch():
    tsdf_window.reset_window_pair_count()
    assert tsdf_window.window_pair_count() == 0


def test_k5_operation_count_is_the_benchmarks():
    """chip_smoke.py bounds K5 by ops.tsdf_window's operation count; the
    benchmark's roofline of step 3 counts the same work."""
    from benchmark.work import integrate as work

    assert (tsdf_window.OPS_PAIR_VOXEL, tsdf_window.OPS_MERGE_VOXEL) == (
        work.OPS_PAIR_VOXEL, work.OPS_MERGE_VOXEL)


@pytest.mark.parametrize("drop", [None, "frame_touched"])
def test_k5_sums_form_refuses_before_any_launch(monkeypatch, drop):
    """`window_sums` (the sharded step's form) takes no tables and refuses
    CPU tensors and a wrong dtype as `integrate_window` does."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the library was loaded"))
    args = _window_args()
    del args["tsdf"], args["weight"]
    exc = ValueError
    if drop is not None:
        args[drop] = args[drop].float()
        exc = TypeError
    with pytest.raises(exc):
        tsdf_window.window_sums(tsdf.TSDFConfig(**dict(CFG, block_resolution=4)), **args)
