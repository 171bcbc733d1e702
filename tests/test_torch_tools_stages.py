"""The port's confidence and ICP reference baselines
(mq3d_tpu_torch/tools/bench_reference_stages.py with its C++ copies
csrc/ref_confidence_cpu.cpp and csrc/ref_icp_cpu.cpp) against the root
sources native/ref_confidence_cpu.cpp and native/ref_icp_cpu.cpp, and the
port's confidence_for_refs and multi_scale_icp against the JAX package's,
on the CPU at a small size.

The root sources are built here with g++ into a temporary directory (the
JAX tool's own flags), so no file of native/ is written.  Sizes: the
tool's box-room orbit at 80x64 with 9 frames; a 20 000-point box cloud
with the tool's perturbation and pyramid.  Tolerances: the C++ copies
equal the root sources bit for bit, on one thread and on two; the port's
confidence maps equal JAX's exactly (tests/test_torch_confidence.py's
rule); the C++ and the port agree to the smoke's gates (valid counts
equal on >= 99.9 % of pixels, p99 |dconf| <= 0.01); the port's ICP
transform within 1e-5 of JAX's (tests/test_torch_icp.py's rule), and
every residual rotation under 0.01 deg.
"""

import ctypes
import json
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mq3d_tpu.ops import icp as jax_icp
from mq3d_tpu.recon import confidence as jax_conf
from mq3d_tpu_torch.tools import bench_reference_stages as st

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, H, W = 9, 64, 80
ICP_POINTS = 20_000
ROOT_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")  # tools/bench_reference_stages.py


@pytest.fixture(scope="module")
def root_libs(tmp_path_factory):
    """The root native sources, built with g++ as the JAX tool builds them."""
    d = tmp_path_factory.mktemp("root_ref_libs")
    out = {}
    for name in ("ref_confidence_cpu", "ref_icp_cpu"):
        so = d / f"lib{name}.so"
        subprocess.run(["g++", *ROOT_FLAGS, str(REPO / "native" / f"{name}.cpp"), "-o",
                        str(so)], check=True, capture_output=True, timeout=300)
        out[name] = ctypes.CDLL(str(so))
    conf = out["ref_confidence_cpu"].conf_build_map
    conf.restype = None
    conf.argtypes = st._CONF_SIGNATURES["conf_build_map"][1]
    icp = out["ref_icp_cpu"].icp_multiscale
    icp.restype = None
    icp.argtypes = st._ICP_SIGNATURES["icp_multiscale"][1]
    return conf, icp


@pytest.fixture(scope="module")
def capture():
    return st.make_capture(N, H, W)


@pytest.fixture(scope="module")
def clouds():
    return st.make_clouds(ICP_POINTS)


def _ok(fn):
    """A C entry that must return 0."""
    def call(*args):
        assert fn(*args) == 0
    return call


def _root_confidence(fn, capture, ref, window):
    depth, K, T_cw, T_wc, _ = capture
    conf = np.zeros(H * W, np.float32)
    cnt = np.zeros(H * W, np.int32)
    fn(st._ptr(depth, st._FP), N, H, W, st._ptr(K, st._FP), st._ptr(T_cw, st._FP),
       st._ptr(T_wc, st._FP), ref, window, st.DEPTH_MAX, st.ERROR_THRESHOLD,
       st._ptr(conf, st._FP), st._ptr(cnt, st._I32P))
    return conf, cnt


def _port_confidence(capture, refs, window):
    inputs = st.port_inputs(capture, "cpu")
    from mq3d_tpu_torch.recon.confidence import confidence_for_refs

    conf, cnt = confidence_for_refs(*inputs, torch.tensor(refs), st.DEPTH_MAX,
                                    st.ERROR_THRESHOLD, window)
    return conf.numpy(), cnt.numpy()


def test_capture_is_the_tools():
    """The box-room orbit renders at the tool's size: most pixels hit."""
    depth, K, T_cw, T_wc, poses = st.make_capture(N, H, W)
    assert depth.shape == (N, H, W) and K.shape == (N, 9) and T_cw.shape == (N, 12)
    assert (depth > 0).mean() > 0.95 and np.isfinite(depth).all()
    np.testing.assert_allclose(T_wc.reshape(N, 3, 4)[:, :, :3],
                               np.linalg.inv(poses)[:, :3, :3], atol=1e-6)


@pytest.mark.parametrize("threads,window", [(1, 3), (2, 3), (2, st.WINDOW)])
def test_confidence_copy_equals_root(root_libs, capture, threads, window):
    """Every reference frame's map from conf_build_maps on `threads`
    threads, and from the copy's conf_build_map, equals the root
    source's conf_build_map bit for bit."""
    depth, K, T_cw, T_wc, _ = capture
    refs = list(range(N))
    conf, cnt = st.confidence_maps(depth, K, T_cw, T_wc, refs, threads, window)
    lib = st.conf_library()
    for r in refs:
        want = _root_confidence(root_libs[0], capture, r, window)
        got = _root_confidence(_ok(lib.conf_build_map), capture, r, window)
        for a, b, c in zip(want, got, (conf[r], cnt[r])):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(c, a)
    assert cnt.mean() > 1 and 0.5 < conf[cnt > 0].mean() <= 1


@pytest.mark.parametrize("window,refs", [(3, [0, 4, 8]), (st.WINDOW, list(range(N)))])
def test_port_confidence_matches_jax(capture, window, refs):
    """The port's confidence_for_refs on the CPU equals JAX's on the
    tool's inputs: counts and maps exact."""
    inputs = st.port_inputs(capture, "cpu")
    conf_j, cnt_j = (np.asarray(x) for x in jax_conf.confidence_for_refs(
        *[jnp.asarray(t.numpy()) for t in inputs], jnp.asarray(refs, jnp.int32),
        depth_max=st.DEPTH_MAX, error_threshold=st.ERROR_THRESHOLD, window=window))
    conf_t, cnt_t = _port_confidence(capture, refs, window)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(conf_t, conf_j)


def test_cpp_and_port_confidence_agree_to_the_smoke_gates(capture):
    depth, K, T_cw, T_wc, _ = capture
    refs = list(range(N))
    for window in (3, st.WINDOW):
        conf, cnt = st.confidence_maps(depth, K, T_cw, T_wc, refs, 2, window)
        pconf, pcnt = _port_confidence(capture, refs, window)
        p = st.confidence_parity(conf, cnt, pconf.reshape(N, -1), pcnt.reshape(N, -1))
        assert p["valid_count_match"] >= 0.999 and p["conf_abs_diff_p99"] <= 0.01, p


def _root_icp(fn, src, dst):
    voxels, dists, iters = st._pyramid()
    T = np.zeros(16, np.float64)
    fit, rmse, it = ctypes.c_double(), ctypes.c_double(), ctypes.c_int32()
    fn(st._ptr(src, st._FP), len(src), st._ptr(dst, st._FP), len(dst),
       st._ptr(voxels, st._FP), st._ptr(dists, st._FP), st._ptr(iters, st._I32P), 3,
       st._ptr(T, st._DP), ctypes.byref(fit), ctypes.byref(rmse), ctypes.byref(it))
    return {"T": T.reshape(4, 4), "fitness": fit.value, "rmse": rmse.value,
            "iterations": it.value}


def test_icp_copy_equals_root(root_libs, clouds):
    """icp_multiscale_pairs on one thread and on two (two pairs: the tool's
    and its reverse), and the copy's icp_multiscale, give the root
    source's transform, fitness, rmse and iterations exactly."""
    src, dst, Rz = clouds
    want = [_root_icp(root_libs[1], src, dst), _root_icp(root_libs[1], dst, src)]
    for threads in (1, 2):
        got = st.icp_pairs([(src, dst), (dst, src)], threads)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["T"], w["T"])
            assert (g["fitness"], g["rmse"], g["iterations"]) == (
                w["fitness"], w["rmse"], w["iterations"])
    lib = st.icp_library()
    one = _root_icp(_ok(lib.icp_multiscale), src, dst)
    np.testing.assert_array_equal(one["T"], want[0]["T"])
    assert want[0]["fitness"] > 0.99 and st.residual_rotation_deg(want[0]["T"], Rz) < 0.01


def test_port_icp_matches_jax_and_recovers_the_perturbation(clouds):
    src, dst, Rz = clouds
    a = jax_icp.multi_scale_icp(
        src, dst, voxel_sizes=list(st.VOXELS),
        criteria_list=[jax_icp.ICPConvergenceCriteria(i) for i in st.ITERS],
        max_correspondence_distances=list(st.DISTS))
    b = st.port_icp(src, dst, "cpu")
    np.testing.assert_allclose(b.transformation, np.asarray(a.transformation), rtol=0,
                               atol=1e-5)
    assert abs(b.fitness - a.fitness) < 1e-6 and b.fitness > 0.99
    for T in (a.transformation, b.transformation):
        assert st.residual_rotation_deg(T, Rz) < 0.01
        np.testing.assert_allclose(np.asarray(T)[:3, 3] + np.asarray(T)[:3, :3] @ st.ICP_SHIFT,
                                   0, atol=1e-3)


def test_zero_sizes_return_the_error_code(capture, clouds):
    """Every C++ entry returns -1 on zero or invalid sizes and writes
    nothing; the Python wrappers raise."""
    depth, K, T_cw, T_wc, _ = capture
    lib = st.conf_library()
    conf = np.full(H * W, 7, np.float32)
    cnt = np.full(H * W, 7, np.int32)
    args = lambda n, h, w, ref, window: (  # noqa: E731
        st._ptr(depth, st._FP), n, h, w, st._ptr(K, st._FP), st._ptr(T_cw, st._FP),
        st._ptr(T_wc, st._FP), ref, window, st.DEPTH_MAX, st.ERROR_THRESHOLD)
    for n, h, w, ref, window in [(0, H, W, 0, 3), (N, 0, W, 0, 3), (N, H, 0, 0, 3),
                                 (N, H, W, 0, 0), (N, H, W, 0, -2), (N, H, W, -1, 3),
                                 (N, H, W, N, 3)]:
        assert lib.conf_build_map(*args(n, h, w, ref, window), st._ptr(conf, st._FP),
                                  st._ptr(cnt, st._I32P)) == -1
    assert (conf == 7).all() and (cnt == 7).all()
    refs = np.zeros(1, np.int64)
    assert lib.conf_build_maps(*args(N, H, W, None, 3)[:7], st._ptr(refs, st._I64P), 0, 3,
                               st.DEPTH_MAX, st.ERROR_THRESHOLD, 2, st._ptr(conf, st._FP),
                               st._ptr(cnt, st._I32P)) == -1
    with pytest.raises(ValueError, match="returned -1"):
        st.confidence_maps(depth, K, T_cw, T_wc, [0, N], 2, 3)
    with pytest.raises(ValueError, match="returned -1"):
        st.confidence_maps(depth[:0], K[:0], T_cw[:0], T_wc[:0], [0], 1, 3)

    src, dst, _ = clouds
    empty = np.zeros((0, 3), np.float32)
    for pair in [(empty, dst), (src, empty)]:
        with pytest.raises(ValueError, match="returned -1"):
            st.icp_pairs([pair], 2)
    with pytest.raises(ValueError, match="returned -1"):
        st.icp_pairs([], 2)
    voxels, dists, iters = st._pyramid()
    ilib = st.icp_library()
    T = np.full(16, 7.0)
    fit, rmse, it = ctypes.c_double(7), ctypes.c_double(7), ctypes.c_int32(7)
    for n_src, n_dst, n_scales, (v, d, i) in [
            (0, 100, 3, (voxels, dists, iters)), (100, 0, 3, (voxels, dists, iters)),
            (100, 100, 0, (voxels, dists, iters)), (100, 100, 3, (voxels * 0, dists, iters)),
            (100, 100, 3, (voxels, -dists, iters)), (100, 100, 3, (voxels, dists, -iters))]:
        assert ilib.icp_multiscale(
            st._ptr(src, st._FP), n_src, st._ptr(dst, st._FP), n_dst, st._ptr(v, st._FP),
            st._ptr(d, st._FP), st._ptr(i, st._I32P), n_scales, st._ptr(T, st._DP),
            ctypes.byref(fit), ctypes.byref(rmse), ctypes.byref(it)) == -1
    assert (T == 7).all() and (fit.value, rmse.value, it.value) == (7, 7, 7)


def test_main_on_the_cpu_prints_its_json_line(monkeypatch, capsys):
    """--parity --device cpu at a small size prints the JAX tool's lines,
    the all-threads figures and one JSON line that passes the smoke's
    gates."""
    for name, value in dict(N_FRAMES=N, H=H, W=W, WINDOW=3, ICP_POINTS=ICP_POINTS,
                            PORT_REFS=3).items():
        monkeypatch.setattr(st, name, value)
    line = st.main(["--parity", "--device", "cpu", "--conf-reps", "2", "--icp-reps", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(line))
    text = "\n".join(out)
    for s in ("confidence C++ single-core:", "multiscale ICP C++ single-core:",
              "transform check: residual rotation", "parity vs mq3d_tpu_torch",
              "mq3d_tpu_torch multi_scale_icp on cpu", "one reference frame each",
              "one pair each", "[info] host CPU"):
        assert s in text, s
    conf, icp = line["confidence"], line["icp"]
    threads = str(line["host"]["threads"])
    assert set(conf["ms_per_ref_frame"]) == {"1", threads}
    assert set(icp["s_per_pair"]) == {"1", threads}
    assert all(v > 0 for v in list(conf["ms_per_ref_frame"].values())
               + list(icp["s_per_pair"].values()))
    assert conf["parity"]["valid_count_match"] >= 0.999
    assert conf["parity"]["conf_abs_diff_p99"] <= 0.01
    assert conf["port_ms_per_ref_frame"] > 0 and icp["port"]["s_per_pair"] > 0
    assert icp["residual_rotation_deg"] < 0.01 and icp["port"]["residual_rotation_deg"] < 0.01


def test_no_hidden_fallback(monkeypatch, capsys):
    """Without CUDA the tool raises unless --device cpu, before printing
    a measurement; reps below 1 are refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        st.main([])
    with pytest.raises(SystemExit):
        st.main(["--device", "cpu", "--icp-reps", "0"])
    assert "C++" not in capsys.readouterr().out


def test_libraries_build_from_the_port_sources():
    import mq3d_tpu_torch.tools._reference as ref

    assert st.CONF_SOURCE == REPO / "mq3d_tpu_torch/csrc/ref_confidence_cpu.cpp"
    assert st.ICP_SOURCE == REPO / "mq3d_tpu_torch/csrc/ref_icp_cpu.cpp"
    for src in (st.CONF_SOURCE, st.ICP_SOURCE):
        lib = ref.build_reference(src, st.GXX_FLAGS)
        assert lib.is_file() and lib.parent.name == "build"
        assert lib == ref.build_reference(src, st.GXX_FLAGS)
