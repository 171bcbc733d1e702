"""Import guard for mq3d_tpu_torch and chip_smoke.py.

The machine with the card has the standard library, torch, numpy and scipy,
but not jax, pandas, cv2, PIL, yaml or tqdm, and the port must not need the
JAX package.  In a fresh interpreter whose import system refuses those
names, every module of mq3d_tpu_torch and chip_smoke must import.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "mq3d_tpu", "pandas", "cv2", "PIL", "yaml", "tqdm")

_SCRIPT = f"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {BLOCKED!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {{name}} refused")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {str(REPO)!r})
import mq3d_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    mq3d_tpu_torch.__path__, "mq3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_forbidden_packages():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) > 40


@pytest.mark.parametrize("module", [
    "mq3d_tpu_torch.ops.mc_tables", "mq3d_tpu_torch.ops.mesh_filter",
    "mq3d_tpu_torch.ops.raycast", "mq3d_tpu_torch.recon.color_opt",
    "mq3d_tpu_torch.ops.sampling"])
def test_slice3_modules_import_under_the_guard(module):
    """The modules of reconstruction steps 4-6, each alone in a fresh
    interpreter under the guard (the walk above imports them too)."""
    walk = _SCRIPT[_SCRIPT.index("names = "):_SCRIPT.index("for name in names")]
    script = _SCRIPT.replace(walk, f"names = [{module!r}]\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "1"


@pytest.mark.parametrize("module", [
    "mq3d_tpu_torch.recon.confidence", "mq3d_tpu_torch.recon.graph_utils",
    "mq3d_tpu_torch.ops.posegraph", "mq3d_tpu_torch.ops.odometry",
    "mq3d_tpu_torch.recon.fragments", "mq3d_tpu_torch.ops.icp",
    "mq3d_tpu_torch.recon.refine", "mq3d_tpu_torch.recon.depth_pose_optimizer",
    "mq3d_tpu_torch.recon.reconstruct"])
def test_slice4_modules_import_under_the_guard(module):
    """The modules of reconstruction steps 1-2, each alone in a fresh
    interpreter under the guard."""
    test_slice3_modules_import_under_the_guard(module)


def test_guard_refuses_a_forbidden_import():
    """The guard itself works: a module importing yaml fails under it."""
    script = _SCRIPT.replace('names = ["chip_smoke"]', 'names = ["yaml"]')
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0 and "refused" in proc.stderr


SLICE8_MODULES = [
    "mq3d_tpu_torch.utils.native", "mq3d_tpu_torch.utils.png",
    "mq3d_tpu_torch.eval.motion_stats", "mq3d_tpu_torch.analysis.sessions",
    *(f"mq3d_tpu_torch.scripts.{name}" for name in (
        "visualize_camera_trajectories", "compute_hmd_motion_stats",
        "compute_controller_motion_stats", "analyze_recording_lengths",
        "analyze_duration_discrepancy", "find_optimal_timestamp_offset",
        "rename_timestamps", "trim_recordings", "analyze_fog_no_fog_mapping"))]


def test_slice8_modules_import_under_the_guard():
    """The native IO runtime's bindings and the host tools, without the
    walk's other modules imported first; importing builds nothing."""
    walk = _SCRIPT[_SCRIPT.index("names = "):_SCRIPT.index("for name in names")]
    script = _SCRIPT.replace(walk, f"names = {SLICE8_MODULES!r}\n") + (
        "from mq3d_tpu_torch.utils import native\n"
        "assert native._runtime.lib is None\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == str(len(SLICE8_MODULES))


def test_native_runtime_builds_from_the_port_source():
    """The runtime's source is the port's own copy; no file of the port
    names the JAX build's native/ directory or its library."""
    from mq3d_tpu_torch.utils import native

    assert native.SOURCE == REPO / "mq3d_tpu_torch/csrc/mqio.cpp"
    for path in (REPO / "mq3d_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cpp", ".cu"):
            text = path.read_text()
            assert "native/mqio" not in text and "_mqio.so" not in text, path
