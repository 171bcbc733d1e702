"""The port's bench (mq3d_tpu_torch/bench.py) and its CPU reference tools
(mq3d_tpu_torch/tools/bench_reference_cpu.py, bench_reference_raycast.py)
against the JAX package's bench.py, on the CPU at a small size.

The root bench.py is loaded by path and its module globals are patched
(N_FRAMES, H, W, CHUNK, and for the raycast H_C, W_C); no file is edited.
Size: 80x64 depth, chunks of 10 frames (scan-fused groups of 5 chunks, 50
frames), tests/test_tsdf.py's config (voxel 0.05 m, 2048 blocks,
grid_dim 16).  Tolerances: the capture bit for bit; each integration
part's final volume exact in n_active, the slot table, the block
coordinates and the weights, tsdf within 1e-5 (the stream tests');
the raycast render as tests/test_torch_raycast.py holds it (hit/miss equal
on >= 99.9 % of pixels, |dz| <= 1e-4 m on >= 99.9 % of the pixels both
hit); the C++ reference's total observations within 2 % of the port's
(bench_reference_cpu's own --parity rule).
"""

import importlib.util
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mq3d_tpu.ops import raycast as jax_rc
from mq3d_tpu.ops import tsdf as jtsdf
from mq3d_tpu_torch import bench as pbench
from mq3d_tpu_torch.ops import tsdf as ttsdf
from mq3d_tpu_torch.tools import bench_reference_cpu as ref_cpu
from mq3d_tpu_torch.tools import bench_reference_raycast as ref_rc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(voxel_size=0.05, block_resolution=16, block_count=2048, grid_dim=16,
             depth_max=4.0, trunc_voxel_multiplier=4.0, alloc_pixel_stride=2,
             chunk_active_capacity=2048, integrate_tile=256)
N, H, W, CHUNK = 100, 64, 80, 10
H_C, W_C = 96, 128


def _load_jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbench():
    """The root bench.py, its globals set to this file's size."""
    mod = _load_jax_bench()
    mod.N_FRAMES, mod.H, mod.W, mod.CHUNK = N, H, W, CHUNK
    mod.H_C, mod.W_C = H_C, W_C
    return mod


@pytest.fixture
def small(monkeypatch):
    """The port's bench at this file's size (its globals patched)."""
    for name, value in dict(N_FRAMES=N, H=H, W=W, CHUNK=CHUNK, H_C=H_C, W_C=W_C,
                            TSDF_SETTINGS=SMALL).items():
        monkeypatch.setattr(pbench, name, value)
    return pbench


@pytest.fixture(scope="module")
def capture():
    return pbench.make_capture(N, H, W)


@pytest.fixture(scope="module")
def jax_sequence(jbench, capture):
    """The JAX volumes that the port's parts must reproduce: the
    per-chunk state of bench.bench_integrate (which returns it), and the
    same frames through integrate_chunks / integrate_chunks_u16 in
    bench.py's groups of 5 chunks."""
    depth, K, T_wc, valid = capture[:4]
    cfg = jtsdf.TSDFConfig(**SMALL)
    _, per_chunk = jbench.bench_integrate(cfg, depth, K, T_wc, valid)
    dq, scale = jtsdf.quantize_depth_u16(depth, cfg.depth_max)
    per = 5 * CHUNK
    fused, u16 = jtsdf.create_state(cfg), jtsdf.create_state(cfg)
    for s0 in range(0, N, per):
        sl = slice(s0, s0 + per)
        args = [jnp.asarray(a[sl].reshape(5, CHUNK, *a.shape[1:]))
                for a in (K, T_wc, valid)]
        fused = jtsdf.integrate_chunks(
            cfg, fused, jnp.asarray(depth[sl].reshape(5, CHUNK, H, W)), *args)
        u16 = jtsdf.integrate_chunks_u16(
            cfg, u16, jnp.asarray(dq[sl].reshape(5, CHUNK, H, W)), jnp.float32(scale), *args)
    return {"per_chunk": per_chunk, "fused": fused, "devres": fused, "u16": u16}


def assert_volume_matches(jax_state, port_state):
    a = {k: np.array(v) for k, v in jax_state._asdict().items()}
    b = ttsdf.state_to_numpy(port_state)
    assert int(b["n_active"]) > 0
    for k in ("n_active", "overflow", "dropped_active", "slot_table", "block_coords",
              "weight"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b["tsdf"], a["tsdf"], atol=1e-5, rtol=0)


def test_make_capture_matches_jax(jbench):
    """make_capture(100, 64, 80) == bench.make_capture() with N_FRAMES,
    H and W patched: depth, K and T_wc bit for bit, and the poses."""
    want = jbench.make_capture()
    got = pbench.make_capture(N, H, W)
    for name, a, b in zip(("depth", "K", "T_wc", "valid"), want[:4], got[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(got[4].positions, want[4].positions)
    np.testing.assert_array_equal(got[4].rotations, want[4].rotations)
    assert np.isfinite(got[0]).all() and (got[0] > 0).mean() > 0.99


def test_production_capture_shape():
    """The bench's own sizes are bench.py's: 1000 frames of 320x288 from
    50 renders, the production TSDF settings."""
    jmod = _load_jax_bench()
    for name in ("N_FRAMES", "H", "W", "H_C", "W_C", "CHUNK", "RAYCAST_BATCH",
                 "LEGACY_RAYCAST_BUDGET_MS"):
        assert getattr(pbench, name) == getattr(jmod, name), name
    cfg = pbench.bench_config()
    assert (cfg.voxel_size, cfg.block_count, cfg.grid_dim, cfg.depth_max,
            cfg.chunk_active_capacity, cfg.integrate_tile) == (0.01, 50_000, 160, 4.0,
                                                              12_288, 512)


@pytest.mark.parametrize("part", ["per_chunk", "fused", "u16", "devres"])
def test_integration_part_matches_jax(part, small, capture, jax_sequence):
    depth, K, T_wc, valid = capture[:4]
    cfg = small.bench_config()
    fn = {"per_chunk": small.bench_integrate, "fused": small.bench_integrate_fused,
          "u16": small.bench_integrate_fused_u16,
          "devres": small.bench_integrate_devres}[part]
    out = fn(cfg, depth, K, T_wc, valid, "cpu", 1)
    rates, state = out[0], out[-1]
    assert len(rates) == 1 and rates[0] > 0
    if part == "devres":
        assert len(out[1]) == 1 and out[1][0] > 0  # staging MB/s
    assert_volume_matches(jax_sequence[part], state)


def test_raycast_part_matches_jax(small, jbench, capture, jax_sequence):
    """bench_raycast's device render of the per-chunk volume against the
    JAX package's _render_frames_device on the JAX volume, same views."""
    depth, K, T_wc, valid, gt, scene_cfg = capture
    cfg = small.bench_config()
    _, state = small.bench_integrate(cfg, depth, K, T_wc, valid, "cpu", 1)
    device_ms, stream_ms, stream_u16_ms, z = small.bench_raycast(cfg, state, gt, scene_cfg,
                                                                 "cpu", 1)
    assert all(len(x) == 1 and x[0] > 0 for x in (device_ms, stream_ms, stream_u16_ms))
    n = 2 * small.RAYCAST_BATCH
    assert z.shape == (n, H_C, W_C)
    jvol = jtsdf.TSDFVolume(jtsdf.TSDFConfig(**SMALL), jax_sequence["per_chunk"])
    fx, fy, cx, cy = small.intrinsics_from_cfg(scene_cfg, W_C, H_C)
    Kb = np.tile(np.array([[fx, 0, W_C - cx], [0, fy, cy], [0, 0, 1]], np.float32), (n, 1, 1))
    Tb = np.linalg.inv(gt.extrinsics_cw[:n].astype(np.float64))
    want, _ = jax_rc._render_frames_device(jvol, Kb, Tb, W_C, H_C)
    want = np.asarray(want)
    fw, fg = np.isfinite(want), np.isfinite(z)
    assert fw.mean() > 0.5
    assert (fw == fg).mean() >= 0.999
    both = fw & fg
    assert (np.abs(z[both] - want[both]) <= 1e-4).mean() >= 0.999


def test_sharded_part_matches_jax(small, capture):
    """bench_sharded_prod on a gloo group of one rank: a warm-up step and
    the timed steps (9 of 10 frames at 100 frames) equal the JAX package's
    integrate_chunk over the same chunks."""
    depth, K, T_wc, valid = capture[:4]
    cfg = small.bench_config()
    rates, state = small.bench_sharded_prod(cfg, depth, K, T_wc, valid, "cpu", 1)
    assert len(rates) == 1 and rates[0] > 0
    jcfg = jtsdf.TSDFConfig(**SMALL)
    want = jtsdf.create_state(jcfg)
    for s in range(0, (1 + min(10, N // CHUNK - 1)) * CHUNK, CHUNK):
        sl = slice(s, s + CHUNK)
        want = jtsdf.integrate_chunk(jcfg, want, *[jnp.asarray(a[sl])
                                                   for a in (depth, K, T_wc, valid)])
    assert_volume_matches(want, state)


def test_main_prints_bench_json_line(small, capsys, monkeypatch):
    """main on the CPU at 100 frames prints exactly one line on stdout (the
    e2e run's log and the raycast's warnings, forced here, go to stderr),
    with every key of bench.py's line, every number finite, and the device
    named as the CPU."""
    from mq3d_tpu_torch.ops import raycast

    monkeypatch.setattr(raycast, "_warn_overflow",
                        lambda overflow: print("[Warning] raycast edge budget exceeded"))
    line = small.main(["--device", "cpu", "--frames", str(N), "--reps", "1"])
    captured = capsys.readouterr()
    assert "[Warning] raycast edge budget exceeded" in captured.err
    assert "[bench] e2e: median" in captured.err and "[Timing]" in captured.err
    out = captured.out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert (line["metric"], line["unit"]) == ("tsdf_frames_per_sec", "frames/s")
    jax_keys = {"tsdf_streamed_frames_per_sec", "tsdf_streamed_u16_frames_per_sec",
                "tsdf_streamed_per_chunk_frames_per_sec", "tsdf_staging_mb_per_sec",
                "raycast_ms_per_frame", "raycast_vs_embree_cpu", "raycast_vs_legacy_budget",
                "raycast_stream_ms_per_frame", "raycast_stream_u16_ms_per_frame",
                "sharded_prod_frames_per_sec", "e2e_pipeline_seconds"}
    assert set(line["extra"]) == jax_keys | {"device"}
    for v in [line["value"], line["vs_baseline"]] + [line["extra"][k] for k in jax_keys]:
        assert np.isfinite(v) and v > 0
    assert line["extra"]["device"]["platform"] == "cpu"
    assert line["extra"]["device"]["host_threads"] >= 1


def test_jax_line_keys_are_the_ports():
    """The keys that bench.py's JSON line writes, read from its source,
    are the port's (plus `device`)."""
    src = (REPO / "bench.py").read_text()
    body = src[src.index('"extra": {'):src.index("}))", src.index('"extra": {'))]
    keys = set(re.findall(r'"(\w+)":', body)) - {"extra"}
    port = (REPO / "mq3d_tpu_torch/bench.py").read_text()
    for k in keys:
        assert f'"{k}"' in port, k


def test_no_hidden_fallback(monkeypatch, capsys):
    """Without CUDA and without --device cpu, main raises before measuring
    and prints no JSON line; so does an invalid frame count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pbench.main([])
    with pytest.raises(SystemExit):
        pbench.main(["--device", "cpu", "--frames", "150"])
    assert capsys.readouterr().out == ""


def test_baselines_are_measured_numbers():
    """The two baseline constants are the reference tools' measurements on
    the card's host, not bench.py's scaled TPU-host numbers."""
    jmod = _load_jax_bench()
    assert pbench.BASELINE_FRAMES_PER_SEC > 0 and pbench.BASELINE_RAYCAST_MS > 0
    assert pbench.BASELINE_FRAMES_PER_SEC != jmod.BASELINE_FRAMES_PER_SEC
    assert pbench.BASELINE_RAYCAST_MS != jmod.BASELINE_RAYCAST_MS


# -- the C++ references -------------------------------------------------------


def test_reference_cpu_parity(capture):
    """The C++ loop (built with g++ here) against the port's integrate on
    20 frames: total observations within 2 %, the same block count, and the
    same result on one thread and on two."""
    depth, K, T_wc = (a[:20] for a in capture[:3])
    cfg = ttsdf.TSDFConfig(**SMALL)
    p = ref_cpu.parity(depth, K, T_wc, cfg, "cpu")
    assert p["port"] > 0 and p["rel"] < ref_cpu.PARITY_REL, p
    assert p["cpp_blocks"] == p["port_blocks"]
    one, two = ref_cpu.Volume(cfg), ref_cpu.Volume(cfg)
    one.integrate(depth, K, T_wc, 1)
    two.integrate(depth, K, T_wc, 2)
    np.testing.assert_array_equal(one.weight, two.weight)
    np.testing.assert_array_equal(one.tsdf, two.tsdf)


def test_reference_cpu_measure_and_guards(capture):
    depth, K, T_wc = (a[:20] for a in capture[:3])
    cfg = ttsdf.TSDFConfig(**SMALL)
    res = ref_cpu.measure(depth, K, T_wc, cfg, reps=2, threads=(1,))
    assert list(res) == [1] and len(res[1]["reps"]) == 2
    assert res[1]["frames_per_sec"] > 0 and res[1]["n_blocks"] > 0
    assert res[1]["omp_threads"] == 1
    vol = ref_cpu.Volume(cfg)
    assert vol.integrate(depth[:0], K[:0], T_wc[:0], 1) >= 0  # no frames: nothing to do
    assert vol.n_blocks == 0
    bad = ttsdf.TSDFConfig(**dict(SMALL, alloc_pixel_stride=0))
    with pytest.raises(RuntimeError, match="returned -1"):
        ref_cpu.Volume(bad).integrate(depth, K, T_wc, 1)


def test_reference_raycast_on_the_port_mesh():
    """The C++ BVH tracer over the port's marching-cubes mesh renders the
    analytic box depth (median error under half a voxel), identically on
    one thread and on two; an empty mesh renders misses only."""
    cfg = ttsdf.TSDFConfig(**SMALL)
    vol, gt, cfg_s = ref_rc.build_volume("cpu", cfg, n_integrate=20, w=W, h=H)
    mesh = vol.extract_triangle_mesh(3.0)
    assert len(mesh.triangles) > 1000
    with ref_rc.Scene(mesh.vertices, mesh.triangles) as scene:
        res = ref_rc.measure(scene, gt, cfg_s, 2, threads=(1, 2), w=W_C, h=H_C)
    np.testing.assert_array_equal(res[1]["depth"], res[2]["depth"])
    acc = ref_rc.accuracy(res[1]["depth"], ref_rc.analytic_depth(gt, cfg_s, 1, W_C, H_C))
    assert acc["coverage"] > 0.7 and acc["median_mm"] < 0.5 * SMALL["voxel_size"] * 1e3, acc
    with ref_rc.Scene(np.zeros((0, 3)), np.zeros((0, 3))) as empty:
        d = empty.render(ref_rc.view_intrinsics(cfg_s, 16, 8), gt.extrinsics_cw[0], 16, 8, 0)
    assert np.isinf(d).all()


def test_reference_tools_arguments_and_build(capsys):
    """The tools refuse sizes they cannot measure, the host is described,
    and the library builds once into build/ and is reused."""
    import mq3d_tpu_torch.tools._reference as ref

    assert ref.host_cpu()["threads"] >= 1 and ref.host_cpu()["cpu"]
    with pytest.raises(SystemExit):
        ref_cpu.main(["5"])
    with pytest.raises(SystemExit):
        ref_rc.main(["0"])
    capsys.readouterr()
    lib_a = ref.build_reference(ref_cpu.SOURCE, ref_cpu.GXX_FLAGS)
    lib_b = ref.build_reference(ref_cpu.SOURCE, ref_cpu.GXX_FLAGS)
    assert lib_a == lib_b and lib_a.is_file() and lib_a.parent.name == "build"
