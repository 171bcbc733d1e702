"""The `sharp.render` cell: its manifest entries, its entry's keyframes,
calls and volumes, the plain reference and the work count on cases small
enough to work out by hand, and a set-up that drops work.  The check that
decides `correct` (program, control, broken timed paths) is driven through
whole runs in test_benchmark_checks.py, with every other cell's, from
tiny/render.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from conftest import tiny, tiny_cell

from benchmark import core
from benchmark.entries import render as entry
from benchmark.generators.quest_session import Session
from benchmark.reference import render as ref
from benchmark.work.render import OPS_HIT, work
from mq3d_tpu_torch.ops import raycast

CELL = "sharp.render"
SEED = 2 ** 31 + 977
M = core.load_manifest()


def test_the_cell_and_its_metrics_are_in_the_manifest():
    cell = core.find_cell(M, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("qrc_sharp", "session_render", 1)
    e2e = {m["name"]: m for m in core.metrics_for(M, CELL, "end_to_end")}
    assert set(e2e) == {"render_fps", "setup_s"}
    assert e2e["render_fps"]["workloads"] == [CELL]
    layers = core.metrics_for(M, CELL, "per_layer")
    assert {m["name"] for m in layers} == {"device_idle_pct.render", "render_d2h_ms_per_frame",
                                           "render_kernel_ms_per_frame", "render_pass_roofline"}
    assert all(m["moves"] == "render_fps" and m["workloads"] == [CELL] for m in layers)
    assert set(core.load_limits(CELL)) == {"depth_mismatch_share"}
    traffic = core.load_traffic("session_render")
    assert (traffic["entry"], traffic["color_width"], traffic["color_height"]) == ("render", 1280,
                                                                                   960)


def test_keyframes_of_the_cell_are_17_a_side_in_calls_of_16_and_1():
    config = core.load_config(M, "qrc_sharp")
    n = 500
    session = Session(depth=torch.zeros(1), K_depth=None, T_cw=None,
                      side=np.repeat(np.arange(2), n), frames_per_side=n)
    kf = ref.keyframes(session, config)
    assert kf == [list(range(0, 500, 30)), list(range(500, 1000, 30))]
    rs = ref.render_settings(config)
    assert ref.batches(len(kf[0]), rs["batch"]) == [(0, 16), (16, 17)]
    assert rs["transfer_u16"] is False


def test_the_check_samples_an_eighth_of_every_view_from_the_seed():
    pixels = ref.checked_pixels(34, 40, 30, SEED)
    again = ref.checked_pixels(34, 40, 30, SEED)
    assert len(pixels) == 34 and all(np.array_equal(a, b) for a, b in zip(pixels, again))
    assert all(len(p) == 150 and len(np.unique(p)) == 150 and np.all(np.diff(p) > 0)
               and 0 <= p[0] and p[-1] < 1200 for p in pixels)
    assert not np.array_equal(pixels[0], pixels[1])
    other = ref.checked_pixels(34, 40, 30, SEED + 1)
    assert not all(np.array_equal(a, b) for a, b in zip(pixels, other))


def _tiny_entry(monkeypatch):
    config, traffic = tiny_cell(CELL)
    session = core.load_part("generators", traffic["generator"]).make(traffic, SEED, "cpu")
    calls, preps = [], []
    render, prep = entry.raycast_in_color_view, raycast.prepare_scene

    def counted_render(volume, dataset, **kw):
        calls.append((id(volume), len(dataset), kw))
        return render(volume, dataset, **kw)

    def counted_prep(*args):
        preps.append(1)
        return prep(*args)

    monkeypatch.setattr(entry, "raycast_in_color_view", counted_render)
    monkeypatch.setattr(raycast, "prepare_scene", counted_prep)
    return entry.Entry(session, config, "cpu", SEED), calls, preps


def test_the_entry_renders_each_side_in_calls_of_16_and_1(monkeypatch):
    e, calls, _ = _tiny_entry(monkeypatch)
    sizes = []
    render_frames = raycast._render_frames_device

    def sized(volume, intrinsics, *args, **kw):
        sizes.append(len(intrinsics))
        return render_frames(volume, intrinsics, *args, **kw)

    monkeypatch.setattr(raycast, "_render_frames_device", sized)
    assert [len(f) for f in e.frames] == [17, 17]
    assert e.step() == 17 and e.step() == 17
    assert sizes == [16, 1, 16, 1]
    assert all(kw == {"frames_per_batch": 16, "transfer_u16": False} for *_, kw in calls)
    # Each view is seen from its frame's pose.
    session = core.load_part("generators", "quest_session_color").make(tiny_cell(CELL)[1], SEED,
                                                                         "cpu")
    T = e.datasets[1].transforms.extrinsics_cw
    assert np.allclose(T, session.T_cw[e.frames[1]], atol=1e-6)


def test_passes_alternate_volumes_and_prepare_the_scene_once_each(monkeypatch):
    e, calls, preps = _tiny_entry(monkeypatch)
    a, b = (id(v) for v in e.vols)
    for st_a, st_b in zip(*(e.vols[i].state.__dict__.values() for i in (0, 1))):
        if isinstance(st_a, torch.Tensor):
            assert torch.equal(st_a, st_b) and st_a.data_ptr() != st_b.data_ptr()
        else:
            assert st_a == st_b
    e.warm()
    assert [c[0] for c in calls] == [b, b] and len(preps) == 1
    for _ in range(6):
        e.step()
    assert [c[0] for c in calls[2:]] == [a, a, b, b, a, a]
    assert len(preps) == 1 + 3 and e.passes == 3


def test_a_set_up_that_drops_blocks_ends_the_run():
    config, traffic = tiny_cell(CELL)
    config["reconstruction"]["depth_integration"]["block_count"] = 32
    session = core.load_part("generators", traffic["generator"]).make(traffic, SEED, "cpu")
    with pytest.raises(RuntimeError, match="dropped"):
        entry.Entry(session, config, "cpu", SEED)


def _plane_config():
    di = {"voxel_size": 0.1, "block_resolution": 2, "trunc_voxel_multiplier": 3.0,
          "depth_max": 4.0, "alloc_pixel_stride": 2, "frames_per_batch": 64}
    return {"reconstruction": {"depth_integration": di}}


def _whole(grid, K, T_cw, width, height, config):
    return ref.render(grid, K, T_cw, width, np.arange(width * height), config).view(height, width)


def test_reference_renders_a_plane_to_its_depth_and_misses_outside():
    # A wall at z = 1 m seen from the origin along +z: blocks of 0.2 m,
    # voxels at x, y in [-0.4, 0.3] and z in [0.6, 1.3]; the tsdf is (1 - z) / 0.3,
    # clamped, linear across the crossing, so trilinear interpolation and
    # the refinement find z = 1 to rounding.
    config = _plane_config()
    b = torch.tensor([(x, y, z) for x in range(-2, 2) for y in range(-2, 2) for z in range(3, 7)])
    off = torch.tensor([(i, j, k) for i in range(2) for j in range(2) for k in range(2)])
    zs = (b[:, None, 2] * 2 + off[None, :, 2]).double() * 0.1
    vol = {"coords": b, "tsdf": torch.clamp((1.0 - zs) / 0.3, -1, 1).float(),
           "weight": torch.ones(len(b), 8)}
    grid = ref.dense_grid(vol, config)
    K = np.array([[4.0, 0, 2.0], [0, 4.0, 2.0], [0, 0, 1]])
    z = _whole(grid, K, np.eye(4), 5, 5, config)
    # Pixel u casts x = (u - 2) / 4 at z = 1: -0.5 and 0.5 leave the
    # lattice (x in [-0.4, 0.3]), the rest hit.
    assert z[2, 2].item() == pytest.approx(1.0, abs=1e-6)
    assert torch.allclose(z[1:4, 1:4], torch.ones(3, 3), atol=1e-5)
    assert all(math.isinf(z[0, i]) and math.isinf(z[i, 0]) and math.isinf(z[4, i])
               for i in range(5))
    # A view turned away from the wall sees nothing.
    back = np.diag([1.0, -1.0, -1.0, 1.0])
    assert torch.isinf(_whole(grid, K, back, 5, 5, config)).all()
    # An unobserved voxel at the crossing leaves the field undefined there.
    vol["weight"][(b == torch.tensor([0, 0, 4])).all(1)] = 0
    z = _whole(ref.dense_grid(vol, config), K, np.eye(4), 5, 5, config)
    assert math.isinf(z[2, 2]) and z[1, 1].item() == pytest.approx(1.0, abs=1e-5)


def test_mismatch_share_by_hand():
    config = _plane_config()
    r = torch.full((4, 4), 2.0)
    r[0, 0] = math.inf
    p = r.clone()
    p[3, 3] += 0.02  # 0.2 voxel: off
    p[3, 0] += 0.005  # 0.05 voxel: within the tolerance
    p[0, 0] = 2.0  # a hit where the reference misses
    p[1, 1] = math.inf  # a miss where it hits
    got = ref.compare(p[None].numpy(), r[None], config)
    assert got == {"depth_mismatch_share": 3 / 16}


def test_render_work_by_hand():
    # Blocks of 0.2 m: (0, 0, 5) ahead of a camera at the origin, and
    # (10, 10, 5) ahead of one at (2.1, 2.1, 0); one call of both views.
    config = _plane_config()
    coords = torch.tensor([[0, 0, 5], [10, 10, 5]])
    K = np.array([[4.0, 0, 2.0], [0, 4.0, 2.0], [0, 0, 1]], np.float32)
    T = np.tile(np.eye(4), (2, 1, 1))
    T[1, :2, 3] = 2.1
    traced = [{"K": np.stack([K, K]), "T_cw": T, "width": 5, "height": 5, "batch": 2}]
    ops, nbytes = work(coords, config, traced)
    # Each view meets one block, the call both: 2 blocks of 8 voxels, tsdf
    # and weight.  Rays into the box x, y in [0, 2.2], z in [1, 1.2]: from
    # the origin those with (u - 2) / 4 and (v - 2) / 4 >= 0, 3 x 3; from
    # (2.1, 2.1, 0) those <= 0, 3 x 3.
    assert nbytes == 2 * 8 * 2 * 4 + 2 * (25 + 9 + 16) * 4
    assert ops == 18 * OPS_HIT
    traced[0]["batch"] = 1
    assert work(coords, config, traced)[1] == nbytes


@pytest.mark.cuda
def test_the_cell_runs_on_the_card(cuda_device):
    config, traffic = tiny_cell(CELL)
    limits = {k: {"limit": v} for k, v in tiny("render").LIMITS.items()}
    r = core.run(CELL, 5, 0.5, True, device="cuda", config=config, traffic=traffic,
                 limits=limits)
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert {"device_idle_pct.render", "render_d2h_ms_per_frame", "render_kernel_ms_per_frame",
            "render_pass_roofline"} <= set(r["metrics"])
