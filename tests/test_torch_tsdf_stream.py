"""The port's uint16 depth stream and scan-fused integration against the
JAX package's (mq3d_tpu_torch/ops/tsdf.py: quantize_depth_u16,
integrate_chunks_u16, TSDFVolume.integrate_scan), and the single-frame
YUV API (ops/yuv.py: assemble_i420, convert_yuv420_888_to_bgr).

Inputs: the JAX package's synthetic box room (80x64 depth, 12 frames) at
tests/test_tsdf.py's config, and at 2 cm voxels, where K1's plain version
(the depth-patch lookup) really runs.  Every comparison is exact:
quantized bytes, n_active, overflow, dropped_active, slot table, block
coordinates, tsdf and weight.  The JAX side runs as tests/test_tsdf.py
runs it (jitted on the CPU; its Pallas lookup in interpret mode).
"""

import numpy as np
import pytest
import torch

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.models.camera import BaseTime as JBaseTime
from mq3d_tpu.models.camera import ImageFormatInfo as JFormat
from mq3d_tpu.models.camera import ImagePlaneInfo as JPlane
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.models.transforms import CoordinateSystem as JaxCS
from mq3d_tpu.ops import tsdf as jtsdf
from mq3d_tpu.ops import yuv as jyuv
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.models.camera import BaseTime, ImageFormatInfo, ImagePlaneInfo
from mq3d_tpu_torch.ops import tsdf as ttsdf
from mq3d_tpu_torch.ops import yuv as tyuv

torch.set_num_threads(1)

BASE = dict(voxel_size=0.05, block_resolution=16, block_count=2048, grid_dim=16,
            depth_max=4.0, trunc_voxel_multiplier=4.0, alloc_pixel_stride=2,
            chunk_active_capacity=2048, integrate_tile=256)
FINE = dict(BASE, voxel_size=0.02, block_count=4096, chunk_active_capacity=4096,
            onehot_patch=32, depth_lookup="pallas")
S, C = 3, 4


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """(S, C, H, W) depth, (S, C, 3, 3) K, (S, C, 4, 4) T_wc, (S, C) valid."""
    d = tmp_path_factory.mktemp("torch_stream_proj")
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=12))
    io = JaxDataIO(d)
    ds = io.depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    depth, valid = io.depth.load_depth_stack(JaxSide.LEFT, ds)
    K = np.asarray(ds.get_render_intrinsic_matrices(), np.float32)
    T = np.asarray(ds.transforms.extrinsics_wc, np.float32)
    n = S * C
    return (depth[:n].reshape(S, C, *depth.shape[1:]), K[:n].reshape(S, C, 3, 3),
            T[:n].reshape(S, C, 4, 4), valid[:n].reshape(S, C))


def _jax_arrays(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


def assert_same_state(jax_state, port_state):
    a, b = _jax_arrays(jax_state), ttsdf.state_to_numpy(port_state)
    assert int(b["n_active"]) > 0
    for k in ("n_active", "overflow", "dropped_active", "slot_table", "block_coords",
              "tsdf", "weight"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def assert_same_port_state(x, y):
    a, b = ttsdf.state_to_numpy(x), ttsdf.state_to_numpy(y)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("depth_max", [4.0, 3.0, 5.5])
def test_quantize_depth_u16_matches_jax(depth_max):
    rng = np.random.default_rng(1)
    scale = 65534.0 / depth_max
    # Rounding ties: float32 depths whose product with the scale lands on
    # k + 0.5 (rint rounds half to even), and their float32 neighbours.
    k = rng.integers(1, 60000, 64).astype(np.float32)
    ties = ((k + np.float32(0.5)) / np.float32(scale)).astype(np.float32)
    ties = np.concatenate([ties, np.nextafter(ties, np.float32(0)),
                           np.nextafter(ties, np.float32(9))])
    special = np.array([0.0, -0.0, -1.0, -1e-9, 1e-9, 1e-5, depth_max,
                        depth_max * 1.0001, depth_max * 2, 1e9, np.inf],
                       np.float32)
    depth = np.concatenate([special, ties, rng.uniform(-1, depth_max * 1.2, 3997)
                            .astype(np.float32)]).reshape(2, 3, 25, 28)
    for d in (depth, depth.astype(np.float64)):
        q_t, s_t = ttsdf.quantize_depth_u16(d, depth_max)
        q_j, s_j = jtsdf.quantize_depth_u16(d, depth_max)
        assert q_t.dtype == np.uint16 and q_t.shape == d.shape
        assert s_t == s_j and type(s_t) is type(s_j)
        np.testing.assert_array_equal(q_t, q_j)
    flat = ttsdf.quantize_depth_u16(depth, depth_max)[0].ravel()
    assert (flat[depth.ravel() <= 0] == 0).all() and (flat[depth.ravel() > 0] >= 1).all()


def _u16_inputs(stack, depth_max):
    depth, K, T, valid = stack
    dq, scale = jtsdf.quantize_depth_u16(depth, depth_max)
    # The host mirror of the device dequantization (tests/test_tsdf.py).
    dep_f = dq.astype(np.float32) * np.float32(1.0 / np.float32(scale))
    return dq, scale, dep_f, K, T, valid


@pytest.mark.parametrize("base", [BASE, FINE], ids=["voxel5cm", "voxel2cm"])
def test_integrate_chunks_u16_matches_jax(stack, monkeypatch, base):
    import jax.numpy as jnp

    dq, scale, dep_f, K, T, valid = _u16_inputs(stack, base["depth_max"])
    jcfg, tcfg = jtsdf.TSDFConfig(**base), ttsdf.TSDFConfig(**base)
    j = jtsdf.integrate_chunks_u16(
        jcfg, jtsdf.create_state(jcfg), jnp.asarray(dq), jnp.float32(scale),
        jnp.asarray(K), jnp.asarray(T), jnp.asarray(valid))
    calls = []
    real = ttsdf.patch_lookup
    monkeypatch.setattr(ttsdf, "patch_lookup", lambda *a: calls.append(1) or real(*a))
    t_q = ttsdf.integrate_chunks_u16(
        tcfg, ttsdf.create_state(tcfg, "cpu"), *_tensors(dq), scale, *_tensors(K, T, valid))
    assert_same_state(j, t_q)
    assert bool(calls) == (base is FINE)  # K1's plain version ran at 2 cm
    t_f = ttsdf.integrate_chunks(tcfg, ttsdf.create_state(tcfg, "cpu"),
                                 *_tensors(dep_f, K, T, valid))
    assert_same_port_state(t_q, t_f)
    # scale given as a float32 tensor: the same reciprocal.
    t_s = ttsdf.integrate_chunks_u16(
        tcfg, ttsdf.create_state(tcfg, "cpu"), *_tensors(dq),
        torch.tensor(scale, dtype=torch.float32), *_tensors(K, T, valid))
    assert_same_port_state(t_q, t_s)


def test_u16_dequantization_is_the_float32_expression(stack, monkeypatch):
    """One ulp matters: the reciprocal is float32(1)/float32(scale), not
    float64 1/scale rounded to float32."""
    dq, scale, dep_f, *_ = _u16_inputs(stack, 2.9)
    inv64 = np.float32(1.0 / scale)
    assert inv64 != np.float32(1.0) / np.float32(scale)  # the two differ at 2.9 m
    seen = {}

    def capture(cfg, state, depth, *rest):
        seen["depth"] = depth.clone()
        return state
    cfg = ttsdf.TSDFConfig(**dict(BASE, depth_max=2.9))
    monkeypatch.setattr(ttsdf, "integrate_chunks", capture)
    ttsdf.integrate_chunks_u16(cfg, ttsdf.create_state(cfg, "cpu"), *_tensors(dq),
                               scale, None, None, None)
    np.testing.assert_array_equal(seen["depth"].numpy(), dep_f)


@pytest.mark.parametrize("base", [BASE, FINE], ids=["voxel5cm", "voxel2cm"])
def test_integrate_scan_matches_jax_and_chunk_calls(stack, base):
    depth, K, T, valid = stack
    jv = jtsdf.TSDFVolume(jtsdf.TSDFConfig(**base))
    tv = ttsdf.TSDFVolume(ttsdf.TSDFConfig(**base), device="cpu")
    jv.integrate_scan(depth, K, T, valid)
    version = tv._state_version
    assert tv.integrate_scan(depth, K, T, valid) is tv
    assert tv._state_version > version  # the raycast cache sees the change
    assert_same_state(jv.state, tv.state)
    per_chunk = ttsdf.TSDFVolume(ttsdf.TSDFConfig(**base), device="cpu")
    for s in range(S):
        per_chunk.integrate(depth[s], K[s], T[s], valid[s], auto_split=False)
    assert_same_port_state(per_chunk.state, tv.state)
    # A second group onto the same volume (tensors this time).
    jv.integrate_scan(depth[::-1], K[::-1], T[::-1], valid[::-1])
    tv.integrate_scan(*_tensors(depth[::-1], K[::-1], T[::-1], valid[::-1]))
    assert_same_state(jv.state, tv.state)


def test_integrate_scan_drops_past_capacity_like_jax(stack):
    """No auto-split: a chunk touching more blocks than
    chunk_active_capacity drops them, counted as in the JAX build, and the
    volume differs from integrate()'s auto-split one."""
    depth, K, T, valid = stack
    kw = dict(BASE, chunk_active_capacity=8, integrate_tile=4)
    jv = jtsdf.TSDFVolume(jtsdf.TSDFConfig(**kw))
    tv = ttsdf.TSDFVolume(ttsdf.TSDFConfig(**kw), device="cpu")
    jv.integrate_scan(depth, K, T, valid)
    tv.integrate_scan(depth, K, T, valid)
    assert tv.state.dropped_active > 0
    assert_same_state(jv.state, tv.state)
    split = ttsdf.TSDFVolume(ttsdf.TSDFConfig(**kw), device="cpu")
    for s in range(S):
        split.integrate(depth[s], K[s], T[s], valid[s])
    assert split.state.dropped_active == 0
    assert split.state.weight.sum() > tv.state.weight.sum()


def _formats(w, h, pixel_stride_uv, row_pad):
    y_rs = w + row_pad
    uv_rs = (w // 2 if pixel_stride_uv == 1 else w) + row_pad
    sizes = [(y_rs * h, y_rs, 1)] + [(uv_rs * (h // 2), uv_rs, pixel_stride_uv)] * 2
    return (JFormat(w, h, "YUV_420_888", [JPlane(*p) for p in sizes], JBaseTime(0, 0)),
            ImageFormatInfo(w, h, "YUV_420_888", [ImagePlaneInfo(*p) for p in sizes],
                            BaseTime(0, 0)))


@pytest.mark.parametrize("pixel_stride_uv,row_pad,uv_order", [
    (1, 0, "NV12"), (1, 16, "NV12"), (2, 8, "NV12"), (2, 8, "NV21"), (2, 0, "NV21")])
def test_single_frame_yuv_matches_jax(pixel_stride_uv, row_pad, uv_order):
    w, h = 64, 48
    jfmt, tfmt = _formats(w, h, pixel_stride_uv, row_pad)
    size = sum(p.buffer_size for p in tfmt.planes[:1 + (pixel_stride_uv == 1) + 1])
    raw = np.random.default_rng(pixel_stride_uv * 100 + row_pad).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    bgr = tyuv.convert_yuv420_888_to_bgr(raw, tfmt, uv_order, device="cpu")
    assert bgr.shape == (h, w, 3) and bgr.dtype == np.uint8
    np.testing.assert_array_equal(bgr, jyuv.convert_yuv420_888_to_bgr(raw, jfmt, uv_order))
    batch = tyuv.convert_yuv_batch([raw, raw], tfmt, uv_order, device="cpu")
    np.testing.assert_array_equal(bgr, batch[1])
    planes = tyuv.split_yuv420_planes(raw, tfmt, uv_order)
    i420 = tyuv.assemble_i420(*planes)
    assert i420.shape == (h * 3 // 2, w) and i420.dtype == np.uint8
    np.testing.assert_array_equal(
        i420, jyuv.assemble_i420(*jyuv.split_yuv420_planes(raw, jfmt, uv_order)))
