"""The `default.integrate` cell: its manifest entries, its entry's chunks
and filter, the plain reference and the work count on cases small enough
to work out by hand, and a pass that drops work.  The check that decides
`correct` (program, control, broken timed paths) is driven through whole
runs in test_benchmark_checks.py, with every other cell's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import tiny, tiny_cell

from benchmark import core
from benchmark.entries import integrate as entry
from benchmark.generators.quest_session import Session
from benchmark.reference import integrate as ref
from benchmark.work.integrate import OPS_MERGE_VOXEL, OPS_PAIR_VOXEL, count
from mq3d_tpu_torch.ops.tsdf import TSDFVolume

CELL = "default.integrate"
SEED = 2 ** 31 + 977
NUMBERS = ("block_mismatch_share", "weight_mismatch_share", "tsdf_mismatch_share")
TINY_LIMITS = tiny("integrate").LIMITS
M = core.load_manifest()


def _run(block_count: int):
    config, traffic = tiny_cell(CELL)
    config["reconstruction"]["depth_integration"]["block_count"] = block_count
    limits = {k: {"limit": v} for k, v in TINY_LIMITS.items()}
    return core.run(CELL, SEED, 0.0, False, device="cpu", config=config, traffic=traffic,
                    limits=limits)


def test_the_cell_and_its_metrics_are_in_the_manifest():
    cell = core.find_cell(M, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("qrc_default", "session_stream", 1)
    e2e = {m["name"]: m for m in core.metrics_for(M, CELL, "end_to_end")}
    assert set(e2e) == {"integrate_fps", "setup_s"}
    assert e2e["integrate_fps"]["workloads"] == [CELL]
    layers = core.metrics_for(M, CELL, "per_layer")
    assert {m["name"] for m in layers} == {"device_idle_pct.integrate", "h2d_ms_per_frame",
                                           "integrate_kernel_ms_per_frame",
                                           "integrate_pass_roofline"}
    assert all(m["moves"] == "integrate_fps" and m["workloads"] == [CELL] for m in layers)
    assert set(core.load_limits(CELL)) == set(NUMBERS)
    assert core.load_traffic("session_stream")["entry"] == "integrate"


def test_the_entry_chunks_filtered_frames_across_the_side_boundary():
    config, traffic = tiny_cell(CELL)
    # The noise-free room is consistent nearly everywhere, so the
    # configuration's threshold (0.02) removes next to nothing: a stricter
    # one shows the filter at work.
    config["reconstruction"]["depth_integration"]["confidence_threshold"] = 0.99
    session = core.load_part("generators", traffic["generator"]).make(traffic, SEED, "cpu")
    e = entry.Entry(session, config, "cpu", SEED)
    # 2 x 76 frames: 64 + 64 + 24, the second chunk holding both sides.
    assert e.chunks == [(0, 64), (64, 128), (128, 152)]
    depth = session.depth.numpy()
    got = e.inputs["depth"]
    assert got.dtype == np.float32 and got.shape == depth.shape
    # The filter only zeroes: some valid pixels go, none is changed.
    kept = got > 0
    assert np.array_equal(got[kept], depth[kept])
    assert 0 < np.count_nonzero((depth > 0) & ~kept) < 0.5 * np.count_nonzero(depth > 0)
    T = e.inputs["T_wc"].astype(np.float64) @ session.T_cw
    assert np.allclose(T, np.eye(4), atol=1e-5)


def _hand_config():
    di = {"voxel_size": 0.1, "block_resolution": 2, "trunc_voxel_multiplier": 1.0,
          "depth_max": 4.0, "alloc_pixel_stride": 2, "frames_per_batch": 64}
    return {"reconstruction": {"depth_integration": di}}


def _hand_inputs(frames=2):
    # A 4x4 wall at depth 1 m, seen from the origin along +z; the samples
    # of stride 2 are pixels (0, 0), (2, 0), (0, 2), (2, 2).
    K = np.array([[4.0, 0, 2.0], [0, 4.0, 2.0], [0, 0, 1]], np.float32)
    return {"depth": np.ones((frames, 4, 4), np.float32),
            "K": np.broadcast_to(K, (frames, 3, 3)).copy(),
            "T_wc": np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1)),
            "valid": np.ones(frames, bool)}


def test_reference_touch_and_average_by_hand():
    config = _hand_config()
    s = ref.settings(config)
    inp = _hand_inputs()
    # Pixel (2, 2) lies at (0, 0, 1); its cube [-0.1, 0.1]^2 x [0.9, 1.1]
    # overlaps blocks (of 0.2 m) x, y in {-1, 0} and z in {4, 5}.  Pixel
    # (0, 0) at (-0.5, -0.5, 1) adds x, y in {-3, -2}.
    keys = ref.touched(torch.ones(4, 4), torch.from_numpy(inp["K"][0]), torch.eye(4), s)
    got = {tuple(c) for c in ref.key_coords(keys).tolist()}
    xy = {-3, -2, -1, 0}
    assert got == {(x, y, z) for x in xy for y in xy for z in (4, 5)}
    vol = ref.integrate(inp, config, "cpu")
    rows = {tuple(c): i for i, c in enumerate(vol["coords"].tolist())}
    # Voxel (0, 0, 1.0) is voxel (0, 0, 0) of block (0, 0, 5): it projects
    # onto pixel (2, 2), depth 1, sdf 0.  Voxel (0, 0, 0.9) is voxel (0, 0, 1)
    # of block (0, 0, 4): sdf 0.1 = trunc, tsdf 1.
    b5, b4 = rows[(0, 0, 5)], rows[(0, 0, 4)]
    assert vol["weight"][b5, 0] == 2 and vol["tsdf"][b5, 0] == pytest.approx(0.0, abs=1e-6)
    assert vol["weight"][b4, 1] == 2 and vol["tsdf"][b4, 1] == pytest.approx(1.0, abs=1e-5)
    # Voxel (0, 0, 1) of block (0, 0, 5) lies at z = 1.1: sdf -0.1 - rounding,
    # or behind the wall: never observed past -trunc.
    assert vol["weight"][b5, 1] in (0, 2)


def test_integrate_work_by_hand():
    config = _hand_config()
    inp = _hand_inputs()
    session = Session(depth=torch.zeros(1), K_depth=inp["K"], T_cw=None, side=None,
                      frames_per_side=2)
    traced = [{"depth": inp["depth"], "K": inp["K"], "T_wc": inp["T_wc"], "valid": inp["valid"]}]
    ops, nbytes = count(session, config, traced)
    # 32 blocks a frame (the test above), the same in both frames: 64 pairs,
    # 32 blocks, 8 voxels a block.
    assert ops == 64 * 8 * OPS_PAIR_VOXEL + 32 * 8 * OPS_MERGE_VOXEL
    assert nbytes == 2 * 16 * 4 + 2 * 25 * 4 + 32 * 8 * 2 * 2 * 4


def test_a_pass_that_drops_blocks_ends_the_run():
    with pytest.raises(RuntimeError, match="dropped"):
        _run(block_count=64)


def test_a_production_volume_is_refused_on_the_cpu():
    _, traffic = tiny_cell(CELL)
    config = core.load_config(M, "qrc_default")
    session = core.load_part("generators", traffic["generator"]).make(traffic, SEED, "cpu")
    with pytest.raises(ValueError, match="for the card"):
        entry.Entry(session, config, "cpu", SEED)


@pytest.mark.cuda
def test_the_cell_runs_on_the_card(cuda_device):
    config, traffic = tiny_cell(CELL)
    limits = {k: {"limit": v} for k, v in TINY_LIMITS.items()}
    r = core.run(CELL, 5, 0.5, True, device="cuda", config=config, traffic=traffic,
                 limits=limits)
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert {"device_idle_pct.integrate", "h2d_ms_per_frame", "integrate_kernel_ms_per_frame",
            "integrate_pass_roofline"} <= set(r["metrics"])
