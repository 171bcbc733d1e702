"""Reconstruction step 1 of mq3d_tpu_torch (depth confidence) against the
JAX package, on the CPU.

The same synthetic capture (the JAX package's writer, 80x64 depth) feeds
both packages.  Tolerances: the valid and consistent counts and the
confidence maps are exact (the port follows XLA's fused multiply-add
chains; counts equal on >= 99.9 % of pixels and never off by more than 1
would have been accepted); the per-pixel error of one pair, which XLA
fuses differently when it is compiled alone, has the same valid mask, is
identical on >= 90 % of the valid pixels and within 1e-6 m elsewhere; the
per-frame npz files and the packed stacks are equal arrays of equal
dtypes, and each package reads the other's pack.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mq3d_tpu.config.configs import DepthConfidenceEstimationConfig as JaxConfConfig
from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.models.transforms import CoordinateSystem as JaxCS
from mq3d_tpu.recon import confidence as jax_conf
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.config.configs import DepthConfidenceEstimationConfig
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.models.camera import ConfidenceMap
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.recon import confidence

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_conf")
    write_synthetic_project(d / "capture", SyntheticSceneConfig(n_frames=8, sweep=1.0))
    io = JaxDataIO(d / "capture")
    ds = io.depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    depth, valid = io.depth.load_depth_stack(JaxSide.LEFT, ds)
    K = ds.get_render_intrinsic_matrices().astype(np.float32)
    T_cw = ds.transforms.extrinsics_cw.astype(np.float32)
    yield d, (depth, K, T_cw, np.linalg.inv(T_cw), valid)
    shutil.rmtree(d, ignore_errors=True)


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("ref,tgt", [(2, 4), (0, 7), (5, 4)])
def test_pair_error_matches_jax(scene, ref, tgt):
    _, (depth, K, T_cw, T_wc, _) = scene
    args = (depth[ref], depth[tgt], K[ref], K[tgt], T_cw[ref], T_wc[tgt], T_cw[tgt])
    err_j, ok_j = (np.asarray(x) for x in jax.jit(jax_conf._pair_error, static_argnums=7)(
        *[jnp.asarray(a) for a in args], 4.0))
    err_t, ok_t = (x.numpy() for x in confidence._pair_error(*_torch(args), 4.0))
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_j.mean() > 0.3
    assert (err_t[ok_j] == err_j[ok_j]).mean() >= 0.9
    np.testing.assert_allclose(err_t[ok_j], err_j[ok_j], rtol=0, atol=1e-6)


@pytest.mark.parametrize("window,threshold,refs", [
    (3, 0.05, [0, 3]), (2, 0.08, [1, 1, 6]), (7, 0.001, list(range(8)))])
def test_confidence_for_refs_matches_jax(scene, window, threshold, refs):
    _, arrays = scene
    conf_j, cnt_j = (np.asarray(x) for x in jax_conf.confidence_for_refs(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(refs, jnp.int32),
        depth_max=4.0, error_threshold=threshold, window=window))
    conf_t, cnt_t = (x.numpy() for x in confidence.confidence_for_refs(
        *_torch(arrays), torch.tensor(refs), 4.0, threshold, window))
    assert cnt_t.dtype == cnt_j.dtype and conf_t.dtype == conf_j.dtype == np.float32
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(conf_t, conf_j)
    assert (cnt_j > 0).mean() > 0.3


@pytest.mark.parametrize("axis,deg", [(0, 90.0), (1, 90.0), (1, 135.0)])
def test_out_of_range_projections_match_jax(scene, axis, deg):
    """A neighbour turned by `deg` about its x (0) or y (1) axis sees
    reference points near or behind its image plane, so their projections
    run far out of int32 range; the port converts them as XLA does
    (saturating, where a plain cast gives INT_MIN on the CPU), and counts
    the same pixels valid (35 such pixels at 90 deg about x)."""
    _, (depth, K, T_cw, _, valid) = scene
    T = T_cw.copy()
    a = np.radians(deg)
    i, j = (1, 2) if axis == 0 else (2, 0)
    turn = np.eye(4, dtype=np.float32)
    turn[[i, i, j, j], [i, j, i, j]] = [np.cos(a), -np.sin(a), np.sin(a), np.cos(a)]
    T[1] = T_cw[0] @ turn
    arrays = (depth, K, T, np.linalg.inv(T), valid)
    _, cnt_j = jax_conf.confidence_for_refs(
        *[jnp.asarray(x) for x in arrays], jnp.asarray([0], jnp.int32),
        depth_max=4.0, error_threshold=0.05, window=1)
    _, cnt_t = confidence.confidence_for_refs(*_torch(arrays), torch.tensor([0]), 4.0, 0.05, 1)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))


def test_consistent_and_corrupted_frames(scene):
    """The JAX package's analytic checks (tests/test_confidence_raycast.py)
    on the port: a rigid scene is consistent, a shrunk frame is not."""
    _, (depth, K, T_cw, T_wc, valid) = scene
    conf, cnt = confidence.confidence_for_refs(
        *_torch((depth, K, T_cw, T_wc, valid)), torch.tensor([0, 3]), 4.0, 0.05, 3)
    seen = cnt >= 2
    assert seen.float().mean() > 0.3 and conf[seen].mean() > 0.95
    bad = depth.copy()
    bad[1] *= 0.7
    conf, cnt = confidence.confidence_for_refs(
        *_torch((bad, K, T_cw, T_wc, valid)), torch.tensor([1]), 4.0, 0.05, 2)
    assert conf[0][cnt[0] >= 2].mean() < 0.3


def _run_both(scene, tmp_path, **cfg):
    d, _ = scene
    shutil.copytree(d / "capture", tmp_path / "jax")
    shutil.copytree(d / "capture", tmp_path / "port")
    for sub in ("left_depth_confidence", "right_depth_confidence", "cache"):
        for p in ("jax", "port"):
            shutil.rmtree(tmp_path / p / sub, ignore_errors=True)
    settings = dict(target_frame_range=2, depth_max=4.0, error_threshold=0.05,
                    skip_if_output_dir_exists=False, frames_per_batch=3)
    settings.update(cfg)
    jax_conf.estimate_depth_confidences(JaxDataIO(tmp_path / "jax").depth,
                                        JaxConfConfig(**settings))
    confidence.estimate_depth_confidences(DataIO(tmp_path / "port").depth,
                                          DepthConfidenceEstimationConfig(**settings),
                                          device="cpu")
    return tmp_path / "jax", tmp_path / "port"


def test_stage_outputs_equal_jax(scene, tmp_path):
    """Per-frame npz files and packs of the whole stage (frames_per_batch 3
    pads the last batch of 8 frames) equal the JAX package's."""
    j, t = _run_both(scene, tmp_path)
    for side in ("left", "right"):
        fj = sorted((j / f"{side}_depth_confidence").glob("*.npz"))
        ft = sorted((t / f"{side}_depth_confidence").glob("*.npz"))
        assert [f.name for f in ft] == [f.name for f in fj] and len(fj) == 8
        for a, b in zip(fj, ft):
            A, B = np.load(a), np.load(b)
            assert A.files == B.files
            for k in A.files:
                assert A[k].dtype == B[k].dtype, k
                np.testing.assert_array_equal(B[k], A[k], err_msg=f"{a.name} {k}")
        for member in ("timestamps", "confidence", "valid_count"):
            a = np.load(j / f"cache/confidence/{side}_{member}.npy")
            b = np.load(t / f"cache/confidence/{side}_{member}.npy")
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def test_packs_cross_load(scene, tmp_path):
    j, t = _run_both(scene, tmp_path, frames_per_batch=8)
    ts = np.asarray(DataIO(t).depth.load_depth_dataset(Side.RIGHT).timestamps)[::-1]
    a = JaxDataIO(t).depth.load_confidence_stack(JaxSide.RIGHT, ts)  # JAX reads the port's
    b = DataIO(j).depth.load_confidence_stack(Side.RIGHT, ts)  # the port reads JAX's
    assert a[2].all() and b[2].all()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_pack_writers(scene, tmp_path):
    """start_confidence_pack puts rows in timestamp order whatever order
    they come in; build_confidence_pack rebuilds the same pack from the
    per-frame maps, as the JAX package's does, and leaves out a map of
    another shape."""
    d, _ = scene
    for pkg in ("jax", "port"):
        shutil.copytree(d / "capture", tmp_path / pkg)
    io, jio = DataIO(tmp_path / "port").depth, JaxDataIO(tmp_path / "jax").depth
    rng = np.random.default_rng(0)
    ts = np.asarray([30, 10, 20], np.int64)
    conf = rng.random((3, 4, 5), dtype=np.float32)
    cnt = rng.integers(0, 9, (3, 4, 5)).astype(np.int32)
    w = io.start_confidence_pack(Side.LEFT, ts, (4, 5), np.float32, (4, 5), np.int32)
    for i in (2, 0, 1):
        w.write(i, conf[i], cnt[i])
    w.finalize()
    got = io.load_confidence_stack(Side.LEFT, ts)
    np.testing.assert_array_equal(got[0], conf)
    np.testing.assert_array_equal(got[1], cnt)
    np.testing.assert_array_equal(np.load(tmp_path / "port/cache/confidence/left_timestamps.npy"),
                                  [10, 20, 30])

    for i, t in enumerate(ts):
        io.save_confidence_map(Side.RIGHT, int(t), ConfidenceMap(conf[i], cnt[i]))
        jio.save_confidence_map(JaxSide.RIGHT, int(t), ConfidenceMap(conf[i], cnt[i]))
    odd = ConfidenceMap(np.zeros((2, 2), np.float32), np.zeros((2, 2), np.int32))
    io.save_confidence_map(Side.RIGHT, 40, odd)
    jio.save_confidence_map(JaxSide.RIGHT, 40, odd)
    assert io.build_confidence_pack(Side.RIGHT) and jio.build_confidence_pack(JaxSide.RIGHT)
    for member in ("timestamps", "confidence", "valid_count"):
        a = np.load(tmp_path / f"jax/cache/confidence/right_{member}.npy")
        b = np.load(tmp_path / f"port/cache/confidence/right_{member}.npy")
        np.testing.assert_array_equal(b, a)
    assert list(np.load(tmp_path / "port/cache/confidence/right_timestamps.npy")) == [10, 20, 30]
    assert not io.build_confidence_pack(Side.LEFT)  # no per-frame maps on that side


def test_cached_maps_are_skipped(scene, tmp_path, capsys):
    j, t = _run_both(scene, tmp_path, frames_per_batch=8)
    io = DataIO(t).depth
    cfg = DepthConfidenceEstimationConfig(target_frame_range=2, depth_max=4.0,
                                          skip_if_output_dir_exists=False)
    confidence.estimate_depth_confidences(io, cfg, device="cpu")
    assert "All confidence maps cached" in capsys.readouterr().out
    cfg.skip_if_output_dir_exists = True
    confidence.estimate_depth_confidences(DataIO(t).depth, cfg, device="cpu")
    assert "output dir exists" in capsys.readouterr().out
