"""The port's profiler spans (`mq3d_tpu_torch.utils.log.span`) on the CPU.

Under torch.profiler a `confidence_for_refs` call opens one
"confidence.call" range holding its five phases in order and one "fma"
range per `fma` call; `estimate_depth_confidences` adds its read-back and
write ranges.  With no profiler running no range is opened at all, the
`[Substep]` lines print as before, and the maps are the same bits either
way.
"""

import re

import numpy as np
import pytest
import torch

from mq3d_tpu_torch.ops import fma as fma_ops
from mq3d_tpu_torch.recon import confidence
from mq3d_tpu_torch.utils import log

PHASES = ["confidence.inputs", "confidence.project", "confidence.sample",
          "confidence.error", "confidence.count"]
FMA_PHASES = {"confidence.project": 12, "confidence.sample": 3, "confidence.error": 8}


def _inputs(n=6, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.8, 1.2, (n, h, w)).astype(np.float32)
    depth[:, 0, :3] = 0.0  # invalid pixels ride along
    K = np.tile(np.array([[14.0, 0, w / 2], [0, 13.0, h / 2], [0, 0, 1]], np.float32), (n, 1, 1))
    T_cw = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T_cw[:, 0, 3] = 0.01 * np.arange(n)
    T_wc = np.linalg.inv(T_cw)
    valid = np.ones(n, bool)
    return [torch.from_numpy(a) for a in (depth, K, T_cw, T_wc, valid)]


def _call(inputs, refs=(1, 4)):
    return confidence.confidence_for_refs(*inputs, torch.tensor(refs), depth_max=4.0,
                                          error_threshold=0.05, window=2)


def _ranges(prof):
    """(name, start_ns, end_ns) of the trace's user-scope ranges, in
    start order."""
    out = [(e.name(), int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
           for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _ranges(prof)


def test_a_call_opens_its_phases_in_order_and_one_fma_range_per_fma(monkeypatch):
    calls = []
    fma = fma_ops.fma

    def counted(*args):
        calls.append(1)
        return fma(*args)

    # apply_pose and norm3 call their module's fma; the bilinear blend its import.
    monkeypatch.setattr(fma_ops, "fma", counted)
    monkeypatch.setattr(confidence, "fma", counted)
    _, ranges = _profiled(lambda: _call(_inputs()))
    call = [r for r in ranges if r[0] == "confidence.call"]
    assert len(call) == 1
    phases = [r for r in ranges if r[0].startswith("confidence.") and r[0] != "confidence.call"]
    assert [r[0] for r in phases] == PHASES
    assert all(_inside(r, call[0]) for r in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))  # one after another
    fmas = [r for r in ranges if r[0] == "fma"]
    assert len(fmas) == len(calls) == 23
    holder = {p[0]: sum(_inside(f, p) for f in fmas) for p in phases}
    assert holder == {"confidence.inputs": 0, "confidence.count": 0, **FMA_PHASES}


def test_stage_and_substep_ranges_open_under_a_profiler():
    timer = log.StageTimer()

    def run():
        with timer.stage("stage.x"), log.substep("substep.y"):
            _call(_inputs(), refs=(2,))

    _, ranges = _profiled(run)
    names = [r[0] for r in ranges]
    assert names[:3] == ["stage.x", "substep.y", "confidence.call"]
    assert _inside(ranges[2], ranges[1]) and _inside(ranges[1], ranges[0])


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    opened = []
    real = log._record_function_with_args_enter

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(log, "_record_function_with_args_enter", counting)
    assert not torch._C._autograd._profiler_enabled()
    timer = log.StageTimer()
    with timer.stage("stage.x"), log.substep("substep.y"), log.span("z"):
        _call(_inputs())
    assert opened == []
    _profiled(lambda: _call(_inputs(), refs=(3,)))  # the same hook counts under a profiler
    assert opened.count("confidence.call") == 1 and opened.count("fma") == 23


def test_substep_lines_are_unchanged_and_spans_never_print(monkeypatch, capsys):
    monkeypatch.setenv("MQ3D_SUBSTEP_TIMING", "1")
    with log.substep("estimate_depth_confidences"):
        _call(_inputs())
    with log.span("quiet"):
        pass
    _profiled(lambda: _call(_inputs()))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert re.fullmatch(r"\[Substep\] estimate_depth_confidences: \d+\.\d{3}s", lines[0])
    monkeypatch.delenv("MQ3D_SUBSTEP_TIMING")
    with log.substep("silent"):
        pass
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("refs", [(0, 5), (2, 3, 3)])
def test_maps_are_bit_equal_with_and_without_a_profiler(refs):
    inputs = _inputs(seed=len(refs))
    off = _call(inputs, refs)
    on, _ = _profiled(lambda: _call(inputs, refs))
    for a, b in zip(off, on):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)


def test_step_one_reads_back_and_saves_inside_its_ranges(tmp_path):
    from mq3d_tpu_torch.config.configs import DepthConfidenceEstimationConfig
    from mq3d_tpu_torch.dataio.data_io import DataIO
    from mq3d_tpu_torch.testing.synthetic import SyntheticSceneConfig, write_synthetic_project

    write_synthetic_project(tmp_path, SyntheticSceneConfig(n_frames=4))
    cfg = DepthConfidenceEstimationConfig(target_frame_range=1, depth_max=4.0,
                                          error_threshold=0.05, skip_if_output_dir_exists=False,
                                          frames_per_batch=3)
    _, ranges = _profiled(lambda: confidence.estimate_depth_confidences(
        DataIO(tmp_path).depth, cfg, device="cpu"))
    names = [r[0] for r in ranges]
    # Two sides of 4 frames at 3 per call: 2 calls a side, each read back
    # and saved, and each side's pack finished.
    assert names.count("confidence.call") == names.count("confidence.readback") == 4
    assert names.count("confidence.save") == 6
    assert len(list((tmp_path / "left_depth_confidence").glob("*.npz"))) == 4
