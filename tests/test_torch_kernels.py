"""mq3d_tpu_torch kernels K1 (patch lookup), K2 (I420 -> BGR), K3
(gather) and K4 (fused multiply-add).

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held here against the JAX package's Pallas kernels in interpret mode and
its XLA reference (K3: jnp.take, the body of the gather probe's Pallas
kernels).  Tolerance: exact (K1 and K3 are pure gathers, K2 integer
arithmetic on uint8).  K4 replaces no Pallas kernel: its plain version is
held against XLA's fused multiply-add by tests/test_torch_fma.py; here its
wrapper's operand rules and the layout it hands the kernel.  The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mq3d_tpu.ops.tsdf_pallas import patch_lookup as jax_patch_lookup
from mq3d_tpu.ops.yuv import yuv420_to_8uc3 as jax_yuv420_to_8uc3
from mq3d_tpu.ops.yuv_pallas import yuv420_to_bgr_pallas
from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops import fma as fma_ops
from mq3d_tpu_torch.ops.fma import broadcast_shape, broadcast_strides, merge_layout
from mq3d_tpu_torch.ops.gather import gather, gather_plain
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup, patch_lookup_plain
from mq3d_tpu_torch.ops.yuv import yuv420_to_8uc3, yuv420_to_bgr

torch.set_num_threads(1)


def _patch_inputs(rng, TP, PS, V):
    patch = rng.random((TP, PS, PS), dtype=np.float32)
    vi = rng.integers(-5, PS + 5, (TP, V), dtype=np.int32)  # out-of-patch too
    ui = rng.integers(-5, PS + 5, (TP, V), dtype=np.int32)
    return patch, vi, ui


def _jax_lookup_padded(patch, vi, ui):
    """The Pallas kernel needs TP % 8 == 0 and V % 128 == 0: pad with
    out-of-patch rows/columns (which read 0.0) and crop."""
    TP, PS, _ = patch.shape
    V = vi.shape[1]
    TPp, Vp = -(-TP // 8) * 8, -(-V // 128) * 128
    pp = np.zeros((TPp, PS, PS), np.float32)
    pp[:TP] = patch
    vp = np.full((TPp, Vp), -1, np.int32)
    up = np.full((TPp, Vp), -1, np.int32)
    vp[:TP, :V] = vi
    up[:TP, :V] = ui
    return np.asarray(jax_patch_lookup(pp, vp, up, interpret=True))[:TP, :V]


@pytest.mark.parametrize("TP,PS,V", [(16, 8, 256), (13, 8, 200), (8, 16, 128), (5, 4, 77)])
def test_k1_plain_matches_pallas_interpret(rng, TP, PS, V):
    """Exact, including TP and V that are not multiples of 8 or 128."""
    patch, vi, ui = _patch_inputs(rng, TP, PS, V)
    want = _jax_lookup_padded(patch, vi, ui)
    got = patch_lookup(*map(torch.from_numpy, (patch, vi, ui)))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = patch_lookup_plain(*map(torch.from_numpy, (patch, vi, ui)))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_k1_out_of_patch_reads_zero(rng):
    patch, vi, ui = _patch_inputs(rng, 4, 8, 64)
    out = patch_lookup(*map(torch.from_numpy, (patch, vi, ui))).numpy()
    outside = (vi < 0) | (vi >= 8) | (ui < 0) | (ui >= 8)
    assert outside.any() and (~outside).any()
    assert (out[outside] == 0.0).all()
    p = np.arange(4)[:, None].repeat(64, 1)
    np.testing.assert_array_equal(out[~outside], patch[p[~outside], vi[~outside], ui[~outside]])


@pytest.mark.parametrize("h,w", [(64, 256), (48, 96)])
def test_k2_plain_matches_pallas_and_xla(rng, h, w):
    """uint8-exact against yuv420_to_bgr_pallas (interpret) and the XLA
    yuv420_to_8uc3, including shapes that are not tile-aligned."""
    y = rng.integers(0, 256, (2, h, w), np.uint8)
    u = rng.integers(0, 256, (2, h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (2, h // 2, w // 2), np.uint8)
    got = yuv420_to_bgr(*map(torch.from_numpy, (y, u, v))).numpy()
    np.testing.assert_array_equal(got, yuv420_to_bgr_pallas(y, u, v, interpret=True))
    np.testing.assert_array_equal(got, np.asarray(jax_yuv420_to_8uc3(y, u, v)))
    rgb = yuv420_to_8uc3(*map(torch.from_numpy, (y, u, v)), order="rgb").numpy()
    np.testing.assert_array_equal(rgb, np.asarray(jax_yuv420_to_8uc3(y, u, v, order="rgb")))


def test_k2_matches_opencv(rng):
    cv2 = pytest.importorskip("cv2")
    h, w = 36, 50
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    i420 = np.concatenate([y.ravel(), u.ravel(), v.ravel()]).reshape(h * 3 // 2, w)
    want = cv2.cvtColor(i420, cv2.COLOR_YUV2BGR_I420)
    got = yuv420_to_bgr(*(torch.from_numpy(p[None]) for p in (y, u, v)))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    f = torch.zeros((2, 4, 4))
    i = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        patch_lookup(f, i.long(), i)
    with pytest.raises(ValueError):
        patch_lookup(torch.zeros((2, 4, 5)), i, i)
    with pytest.raises(ValueError):
        patch_lookup(f.to("meta"), i.to("meta"), i.to("meta"))
    y = torch.zeros((1, 6, 8), dtype=torch.uint8)
    c = torch.zeros((1, 3, 4), dtype=torch.uint8)
    with pytest.raises(TypeError):
        yuv420_to_bgr(y.float(), c, c)
    with pytest.raises(ValueError):
        yuv420_to_bgr(torch.zeros((1, 5, 8), dtype=torch.uint8), c, c)
    with pytest.raises(ValueError):
        yuv420_to_bgr(y.to("meta"), c.to("meta"), c.to("meta"))


def test_cpu_calls_count_no_launch(rng):
    """The CPU path is the plain version: no kernel launch is counted."""
    _build.reset_launch_counts()
    patch, vi, ui = _patch_inputs(rng, 2, 4, 16)
    patch_lookup(*map(torch.from_numpy, (patch, vi, ui)))
    y = torch.zeros((1, 4, 4), dtype=torch.uint8)
    c = torch.zeros((1, 2, 2), dtype=torch.uint8)
    yuv420_to_bgr(y, c, c)
    gather(torch.zeros(8), torch.zeros(4, dtype=torch.int32))
    fma_ops.fma(torch.ones(4), torch.ones(4), torch.ones(4))
    assert _build.launch_counts() == {"patch_lookup": 0, "i420_to_bgr": 0, "gather": 0,
                                      "fma": 0, "tsdf_window": 0, "ray_march": 0}


def test_build_sources_and_flags():
    """Every csrc/*.cu is compiled for sm_90a (one nvcc process per source,
    all started together, then one link); no source includes PyTorch's
    headers; the build hash follows the sources."""
    srcs = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert srcs == ["fma.cu", "gather.cu", "i420.cu", "patch_lookup.cu", "ray_march.cu",
                    "tsdf_window.cu"]
    for p in _build.CSRC_DIR.glob("*.cu"):
        text = p.read_text()
        assert "torch/extension.h" not in text and "ATen" not in text
        assert "cudaGetLastError" in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-v" in _build.NVCC_FLAGS  # ptxas reports registers and spills
    assert len(_build._source_hash()) == 16
    assert set(_build._SIGNATURES) == {
        "mq3d_patch_lookup", "mq3d_i420_to_bgr", "mq3d_gather", "mq3d_fma",
        "mq3d_tsdf_window", "mq3d_ray_march"}
    fma = (_build.CSRC_DIR / "fma.cu").read_text()
    assert 'extern "C" int mq3d_fma(' in fma and "__fmaf_rn" in fma
    k5 = (_build.CSRC_DIR / "tsdf_window.cu").read_text()
    assert 'extern "C" int mq3d_tsdf_window(' in k5 and "__fdiv_rn" in k5
    k6 = (_build.CSRC_DIR / "ray_march.cu").read_text()
    assert 'extern "C" int mq3d_ray_march(' in k6 and "__fsqrt_rn" in k6
    assert not any("fast_math" in f or "ftz" in f for f in _build.NVCC_FLAGS)


@pytest.mark.parametrize("bad,exc", [
    (lambda x: (x.double(), x, x), TypeError),  # float64
    (lambda x: (x, x.int(), x), TypeError),  # integer
    (lambda x: (x, x, x.to("meta")), ValueError),  # mixed devices
    (lambda x: (x.to("meta"),) * 3, ValueError),  # neither the CPU nor a card
    (lambda x: (x, 0.1, x), TypeError),  # a scalar float32 cannot hold
    (lambda x: (x, x, 2 ** 24 + 1), TypeError),
    (lambda x: (x, np.float64(1e39), x), TypeError),  # float32 overflows
    (lambda x: (x, True, x), TypeError),
    (lambda x: (x, "1", x), TypeError),
    (lambda x: (1.0, 2.0, 3.0), TypeError),  # no tensor
    (lambda x: (x, 2.0, x), TypeError),  # a scalar float32 holds: no tensor either
    (lambda x: (x, np.float32(0.5), x), TypeError),
])
def test_fma_rejects_what_it_does_not_take(bad, exc):
    with pytest.raises(exc):
        fma_ops.fma(*bad(torch.ones(3)))


@pytest.mark.parametrize("zero_dim", ["a", "ab", "c"])
def test_fma_plain_computes_in_float64_whichever_operand_is_0d(rng, zero_dim):
    """A 0-d operand gives the bits of the same value broadcast: the plain
    version makes each operand float64 itself, where PyTorch's promotion
    would keep a 0-d float64 `a` times a float32 `b` in float32."""
    a, b, c = (torch.from_numpy(rng.standard_normal((64, 9), dtype=np.float32))
               for _ in range(3))
    if "a" in zero_dim:
        a = a[0, 0]
    if "b" in zero_dim:
        b = b[0, 0]
    if "c" in zero_dim:
        c = c[0, 0]
    full = [t.expand(64, 9).contiguous() for t in (a, b, c)]
    got, want = fma_ops.fma(a, b, c), fma_ops.fma_plain(*full)
    assert got.shape == want.shape == (64, 9)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


def test_fma_on_cpu_takes_the_plain_version(monkeypatch, rng):
    """CPU tensors run `fma_plain`, unchanged, and launch nothing."""
    calls = []
    plain = fma_ops.fma_plain
    monkeypatch.setattr(fma_ops, "fma_plain", lambda *t: calls.append(t) or plain(*t))
    monkeypatch.setattr(fma_ops, "fma_cuda", lambda *t: pytest.fail("the kernel was called"))
    _build.reset_launch_counts()
    a, b, c = (torch.from_numpy(rng.standard_normal((5, 7), dtype=np.float32))
               for _ in range(3))
    got = fma_ops.fma(a, b[:, :1], c)
    assert len(calls) == 1 and calls[0][0] is a and calls[0][2] is c
    np.testing.assert_array_equal(got.numpy(), plain(a, b[:, :1], c).numpy())
    assert _build.launch_counts()["fma"] == 0


@pytest.mark.parametrize("shapes", [((2, 1), (1, 3)), ((), (4,)), ((5, 1, 3), (2, 3), ()),
                                    ((0, 1), (1, 4)), ((3, 0), (0,)), ((1,), (1, 1, 1)),
                                    ((2,), (3,)), ((0,), (2,))])
def test_broadcast_shape_is_torchs(shapes):
    """The wrapper's broadcast (plain Python, so its first call imports
    nothing) gives torch.broadcast_shapes' shape, and raises where torch
    does."""
    try:
        want = tuple(torch.broadcast_shapes(*shapes))
    except RuntimeError:
        with pytest.raises(ValueError):
            broadcast_shape(*shapes)
        return
    assert broadcast_shape(*shapes) == want


def test_launch_record_is_an_operator_inside_the_span():
    """Under a profiler, `_build.launch_record` is an operator-scope event
    (not a user range) that begins inside the span around it, the link
    torch.profiler gives a kernel launched in it."""
    from mq3d_tpu_torch.utils.log import span

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("fma"):
            with _build.launch_record("mq3d::fma"):
                torch.ones(2).add_(1)
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    rng, op = ev["fma"], ev["mq3d::fma"]
    assert rng.is_user_annotation() and not op.is_user_annotation()
    assert rng.start_ns() <= op.start_ns()
    assert op.start_ns() + op.duration_ns() <= rng.start_ns() + rng.duration_ns()



@pytest.mark.parametrize("name", ["patch_lookup", "i420_to_bgr", "gather", "fma", "tsdf_window",
                                  "ray_march"])
def test_launch_calls_the_entry_in_its_record_then_counts(monkeypatch, name):
    """`_build.launch` calls mq3d_<name>(*args, stream) on the device's
    current stream inside the operator record "mq3d::<name>", then counts
    the launch; a non-zero cudaError raises and counts nothing."""
    import types

    calls = []

    def entry(*args):
        calls.append(args)
        torch.ones(2).add_(1)  # an operator inside the record
        return calls[-1][0]

    lib = types.SimpleNamespace(**{f"mq3d_{name}": entry})
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=77))
    _build.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _build.launch(name, torch.device("cuda"), 0, 5, 6)
    assert calls == [(0, 5, 6, 77)]
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    rec, op = ev[f"mq3d::{name}"], ev["aten::add_"]
    assert rec.start_ns() <= op.start_ns()
    assert op.start_ns() + op.duration_ns() <= rec.start_ns() + rec.duration_ns()
    assert _build.launch_counts()[name] == 1
    with pytest.raises(RuntimeError, match=f"{name} failed to launch: cudaError 3"):
        _build.launch(name, torch.device("cuda"), 3)
    assert _build.launch_counts()[name] == 1


def _layout_offsets(sizes, strides):
    """Each element's offset, in the output's order, from a merged layout."""
    n = int(np.prod(sizes)) if sizes else 1
    i = np.arange(n)
    off = np.zeros(n, np.int64)
    for size, st in zip(sizes, strides):
        off += (i % size) * st
        i = i // size
    return off


@pytest.mark.parametrize("case", [
    # (operand shapes and views) -> the number of dimensions left
    "contiguous", "scalar", "expanded", "strided", "pose_scalar", "transposed", "size1"])
def test_merge_layout_reads_what_broadcasting_reads(case):
    """The merged layout addresses, element by element, what each operand's
    broadcast view holds, and leaves as few dimensions as the views allow."""
    base = torch.arange(4 * 5 * 6 * 3, dtype=torch.float32).reshape(4, 5, 6, 3)
    ops, ndim = {
        "contiguous": ((base, base + 1, base * 2), 1),
        "scalar": ((base, torch.tensor(2.0), base), 1),
        "expanded": ((base[:, :1].expand(4, 5, 6, 3), base, base[..., :1]), 4),
        "strided": ((base[..., 1], base[..., 2], base[..., 0].contiguous()), 1),
        "pose_scalar": ((base[:, :1, :, 0], base[:, :, :1, 0], torch.zeros(4, 5, 6)), 3),
        "transposed": ((base.transpose(0, 2), base.transpose(0, 2).contiguous(),
                        torch.tensor(1.0)), 4),
        "size1": ((base[:1, :, :1], base[:1, :, :1], base[:1, :, :1]), 2),
    }[case]
    shape = broadcast_shape(*(t.shape for t in ops))
    sizes, strides = merge_layout(shape, [broadcast_strides(t, shape) for t in ops])
    assert len(sizes) == ndim and all(n >= 2 for n in sizes)
    assert int(np.prod(sizes)) == int(np.prod(shape))
    for t, st in zip(ops, strides):
        flat = torch.as_strided(t, (t.untyped_storage().nbytes() // 4 - t.storage_offset(),),
                                (1,)).numpy()
        got = flat[_layout_offsets(sizes, st)]
        np.testing.assert_array_equal(got, t.expand(shape).reshape(-1).numpy())


@pytest.mark.parametrize("n,m", [(1 << 12, 1 << 10), (1 << 16, 4099), (7, 1)])
def test_k3_plain_matches_jnp_take(n, m):
    """The gather probe's inputs (tools/probe_pallas_gather.py `make`, at
    smaller sizes): exact against jnp.take, the Pallas kernels' body."""
    from mq3d_tpu_torch.tools.probe_gather import make_inputs

    table, idx = make_inputs(n, m, seed=0)
    want = np.asarray(jnp.take(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()), axis=0))
    np.testing.assert_array_equal(gather(table, idx).numpy(), want)
    np.testing.assert_array_equal(gather_plain(table, idx).numpy(), want)


def test_k3_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        gather(torch.zeros(8, dtype=torch.float64), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        gather(torch.zeros(8), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        gather(torch.zeros((2, 4)), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather(torch.zeros(8).to("meta"), torch.zeros(4, dtype=torch.int32).to("meta"))


def test_probe_gather_cli_on_the_cpu(capsys):
    """The probe runs its plain version on the CPU and times nothing."""
    from mq3d_tpu_torch.tools import probe_gather

    assert probe_gather.main(["--device", "cpu", "--sizes-mb", "0.125", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "not timed (CPU)" in out[0] and "(fits shared memory)" in out[0]
    assert "(fits L2)" in out[1]
    assert '"probe_gather"' in out[-1]
