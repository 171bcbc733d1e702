"""mq3d_tpu_torch host modules held against the JAX package.

Same inputs (numpy, seeded, or the JAX package's synthetic capture) go
through both packages.  Tolerances: exact for datasets, depth stacks, CSV
floats, PNG pixels and device-independent geometry; 1e-12 (float64) for
pose interpolation and for geometry evaluated on torch tensors, whose
libm/vector paths may differ from numpy's in the last bit.
"""

import io

import numpy as np
import pytest
import torch

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.dataio.pose_interpolator import PoseInterpolator as JaxPoseInterpolator
from mq3d_tpu.geometry import quaternion as jq
from mq3d_tpu.geometry import se3 as jse3
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.models.transforms import CoordinateSystem as JaxCS
from mq3d_tpu.ops import depth as jdepth
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.config.configs import PipelineConfigs
from mq3d_tpu_torch.dataio.csv_io import parse_float
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.dataio.pose_interpolator import PoseInterpolator
from mq3d_tpu_torch.device import config_device, resolve_device
from mq3d_tpu_torch.geometry import quaternion as tq
from mq3d_tpu_torch.geometry import se3 as tse3
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops import depth as tdepth
from mq3d_tpu_torch.utils.png import decode_png, encode_png, imread_bgr, imwrite

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_modules_proj")
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=12))
    return d


def _assert_dataset_equal(a, b):
    da, db = a.to_dict(), b.to_dict()
    assert da.keys() == db.keys()
    for k in da:
        if isinstance(da[k], np.ndarray):
            assert da[k].dtype == db[k].dtype, k
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        else:
            assert str(da[k]) == str(db[k]), k


# -- geometry ------------------------------------------------------------------------


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("fn,nargs", [
    ("multiply", 2), ("as_matrix", 1), ("conjugate", 1), ("slerp", 2),
    ("rotate", 1), ("from_matrix", 1),
])
def test_quaternion_numpy_and_torch_match_jax_package(rng, fn, nargs):
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    if fn == "slerp":
        args = (q1, q2, rng.random((64, 1)))
    elif fn == "rotate":
        args = (q1, rng.normal(size=(64, 3)))
    elif fn == "from_matrix":
        args = (jq.as_matrix(q1),)
    else:
        args = (q1, q2)[:nargs]
    want = np.asarray(getattr(jq, fn)(*args))
    np.testing.assert_array_equal(getattr(tq, fn)(*args), want)
    got_t = getattr(tq, fn)(*(torch.from_numpy(np.asarray(a)) for a in args))
    np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fn", ["se3_exp", "se3_log", "se3_inverse", "so3_log"])
def test_se3_numpy_and_torch_match_jax_package(rng, fn):
    xi = rng.normal(size=(32, 6))
    arg = {"se3_exp": xi, "so3_log": jse3.so3_exp(xi[:, :3])}.get(fn, jse3.se3_exp(xi))
    want = np.asarray(getattr(jse3, fn)(arg))
    np.testing.assert_array_equal(getattr(tse3, fn)(arg), want)
    np.testing.assert_allclose(getattr(tse3, fn)(torch.from_numpy(arg)).numpy(), want,
                               rtol=0, atol=1e-12)


def test_depth_conversion_matches_jax_package(rng):
    d = rng.random((3, 6, 7))
    near = np.array([0.1, 0.2, 0.3])
    far = np.array([5.0, np.inf, 0.2])  # finite, infinite and degenerate planes
    want = jdepth.convert_depth_to_linear(d, near, far)
    np.testing.assert_array_equal(tdepth.convert_depth_to_linear(d, near, far), want)
    got = tdepth.convert_depth_to_linear(*map(torch.from_numpy, (d, near, far)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    vals = np.array([0.0, 0.1, 2.55, 5.0, 99.0])
    np.testing.assert_array_equal(tdepth.linear_depth_to_png_values(vals, 0.1, 5.0),
                                  jdepth.linear_depth_to_png_values(vals, 0.1, 5.0))


# -- datasets, transforms, depth stacks -----------------------------------------------


@pytest.mark.parametrize("side", ["LEFT", "RIGHT"])
def test_depth_dataset_and_stack_equal(project, side):
    jio, tio = JaxDataIO(project), DataIO(project)
    jds = jio.depth.load_depth_dataset(JaxSide[side], use_cache=False)
    tds = tio.depth.load_depth_dataset(Side[side], use_cache=False)
    _assert_dataset_equal(jds, tds)
    jd, jv = jio.depth.load_depth_stack(JaxSide[side], jds)
    td, tv = tio.depth.load_depth_stack(Side[side], tds)
    assert td.dtype == np.float32
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tv, jv)

    jds.transforms = jds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    tds.transforms = tds.transforms.convert_coordinate_system(
        CoordinateSystem.OPEN3D, is_camera=True)
    np.testing.assert_array_equal(tds.transforms.positions, jds.transforms.positions)
    np.testing.assert_array_equal(tds.transforms.rotations, jds.transforms.rotations)
    np.testing.assert_array_equal(tds.transforms.extrinsics_wc, jds.transforms.extrinsics_wc)
    np.testing.assert_array_equal(tds.get_render_intrinsic_matrices(),
                                  jds.get_render_intrinsic_matrices())


def test_dataset_npz_cross_load(project, tmp_path):
    jds = JaxDataIO(project).depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    jds.save(tmp_path / "d.npz")
    from mq3d_tpu.models.datasets import DepthDataset as JaxDepthDataset
    from mq3d_tpu_torch.models.datasets import DepthDataset

    tds = DepthDataset.load(tmp_path / "d.npz")
    _assert_dataset_equal(jds, tds)
    tds[2:7].save(tmp_path / "t.npz")
    _assert_dataset_equal(JaxDepthDataset.load(tmp_path / "t.npz"), tds[2:7])


def test_pose_interpolation_matches_jax_package(project):
    jp = JaxPoseInterpolator(project / "hmd_poses.csv")
    tp = PoseInterpolator(project / "hmd_poses.csv")
    ts = np.array([999_000, 1_000_000, 1_000_010, 1_000_033, 1_000_100,
                   1_000_200, 1_000_362, 1_000_400, 1_040_000])
    for a, b in zip(jp.interpolate_poses(ts), tp.interpolate_poses(ts)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tp.times, jp.times)
    np.testing.assert_array_equal(tp.positions, jp.positions)


def test_pose_csv_bad_rows_skipped_like_pandas(tmp_path):
    p = tmp_path / "hmd.csv"
    p.write_text(
        "unix_time,pos_x,pos_y,pos_z,rot_x,rot_y,rot_z,rot_w\n"
        "2000,1,2,3,0,0,0,1\n"
        "1000,0.5,0.25,-1.5,0,0,0.7071067811865476,0.7071067811865476\n"
        "1500,,2,3,0,0,0,1\n"          # missing value -> dropped
        "1600,1,2,3,0,0,0,1,9\n"       # too many fields -> skipped
        "1700,nan,2,3,0,0,0,1\n"       # NaN -> dropped
        "3000,-0.14999999999999994,1e-3,2E2,0,0,0,1\n"
    )
    jp, tp = JaxPoseInterpolator(p), PoseInterpolator(p)
    jp._ensure_loaded()
    tp._ensure_loaded()
    np.testing.assert_array_equal(tp.times, jp.times)
    np.testing.assert_array_equal(tp.positions, jp.positions)
    np.testing.assert_array_equal(tp.rotations, jp.rotations)


def test_parse_float_matches_pandas(rng):
    pd = pytest.importorskip("pandas")
    vals = np.concatenate([rng.normal(size=2000), rng.normal(size=500) * 1e-6,
                           rng.normal(size=500) * 1e9])
    texts = [repr(float(v)) for v in vals] + [
        "-0.14999999999999994", "1.5e3", "-2E-4", "+3.25", "7", "0.5", "1e-310",
        "123456789012345678901.5", "0.000000000000000000012345678901234567"]
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(texts) + "\n"))["x"].to_numpy()
    np.testing.assert_array_equal(np.array([parse_float(t) for t in texts]), want)


# -- PNG --------------------------------------------------------------------------------


def test_png_roundtrip_against_opencv(rng, tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    gray = rng.integers(0, 256, (20, 9), np.uint8)
    imwrite(tmp_path / "c.png", img)
    imwrite(tmp_path / "g.png", gray)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "c.png")), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), 0), gray)
    # cv2 picks per-row filters (Sub, Up, Average, Paeth): the reader undoes them.
    smooth = (np.add.outer(np.arange(40), 3 * np.arange(60))[..., None]
              * np.array([1, 2, 3]) % 256).astype(np.uint8)
    for im in (img, smooth):
        cv2.imwrite(str(tmp_path / "r.png"), im)
        np.testing.assert_array_equal(imread_bgr(tmp_path / "r.png"), im)
    assert decode_png(encode_png(gray)).shape == gray.shape


# -- device and config ------------------------------------------------------------------


def test_device_resolver_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(torch.device("cuda", 0))
    with pytest.raises(ValueError):
        resolve_device("mps")
    from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume

    with pytest.raises(RuntimeError):
        TSDFVolume(TSDFConfig(grid_dim=4, block_count=4))  # default device="cuda"


@pytest.mark.parametrize("s", ["tpu", "CPU:0", "cuda", "CUDA:0", "auto", "gpu"])
def test_yaml_device_strings_map_to_the_card(s):
    dev = config_device(s)
    assert dev.type == "cuda"


def test_repo_yamls_parse(tmp_path):
    pytest.importorskip("yaml")
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "config"
    for yml in sorted(root.glob("*.yml")):
        cfg = PipelineConfigs.parse_config_yml(yml)
        assert cfg.reconstruction.device.type == "cuda"
        assert cfg.reconstruction.depth_integration.device.type == "cuda"
        assert cfg.reconstruction.depth_integration.voxel_size > 0
