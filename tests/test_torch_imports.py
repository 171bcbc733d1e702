"""Import guard for mq3d_tpu_torch and chip_smoke.py.

The machine with the card has the standard library, torch, numpy and scipy,
but not jax, pandas, cv2, PIL, yaml, tqdm, matplotlib or seaborn, and the
port must not need the JAX package.  In a fresh interpreter whose import
system refuses those names, every module of mq3d_tpu_torch and chip_smoke
must import.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "mq3d_tpu", "pandas", "cv2", "PIL", "yaml", "tqdm",
           "matplotlib", "seaborn")

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


STUDY_MODULES = [
    "mq3d_tpu_torch.analysis.stats", "mq3d_tpu_torch.analysis.report",
    "mq3d_tpu_torch.analysis.plots",
    *(f"mq3d_tpu_torch.scripts.{name}" for name in (
        "analyze_hmd_motion_stats", "analyze_hmd_motion_stats_median",
        "analyze_controller_motion_stats", "analyze_combined_motion_stats",
        "analyze_mesh_quality_stats", "analyze_simple_mesh_metrics",
        "generate_simple_pairwise_report", "generate_comprehensive_quality_analysis",
        "analyze_survey_hypotheses", "generate_participant_demographics"))]


@pytest.mark.parametrize("module", STUDY_MODULES)
def test_study_modules_import_under_the_guard(module):
    """The study-analysis layer and its CLIs, each alone in a fresh
    interpreter under the guard: pandas, matplotlib and seaborn are
    imported only inside the functions that draw or build frames."""
    test_slice3_modules_import_under_the_guard(module)


BENCH_MODULES = ["mq3d_tpu_torch.bench", "mq3d_tpu_torch.tools._reference",
                 "mq3d_tpu_torch.tools.bench_reference_cpu",
                 "mq3d_tpu_torch.tools.bench_reference_raycast"]


@pytest.mark.parametrize("module", BENCH_MODULES)
def test_bench_modules_import_under_the_guard(module):
    """The bench and its CPU reference tools, each alone in a fresh
    interpreter under the guard: neither jax nor mq3d_tpu, and yaml only
    inside bench_e2e; importing builds no reference library."""
    walk = _SCRIPT[_SCRIPT.index("names = "):_SCRIPT.index("for name in names")]
    script = _SCRIPT.replace(walk, f"names = [{module!r}]\n") + (
        "from mq3d_tpu_torch.tools import bench_reference_cpu, bench_reference_raycast\n"
        "assert bench_reference_cpu._lib.lib is None\n"
        "assert bench_reference_raycast._lib.lib is None\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "1"


def test_reference_tools_build_from_the_port_sources():
    """The reference tools compile the port's own copies of the C++
    baselines, not the JAX build's native/ files."""
    from mq3d_tpu_torch.tools import bench_reference_cpu, bench_reference_raycast

    assert bench_reference_cpu.SOURCE == REPO / "mq3d_tpu_torch/csrc/ref_tsdf_cpu.cpp"
    assert bench_reference_raycast.SOURCE == REPO / "mq3d_tpu_torch/csrc/ref_raycast_cpu.cpp"
    for mod in (bench_reference_cpu, bench_reference_raycast):
        assert "native/" not in Path(mod.__file__).read_text(), mod.__name__


SLICE11_MODULES = ["mq3d_tpu_torch.tools.bench_reference_stages",
                   "mq3d_tpu_torch.tools.run_prod_e2e", "mq3d_tpu_torch.tools.bench_raycast"]


@pytest.mark.parametrize("module", SLICE11_MODULES)
def test_slice11_tools_import_under_the_guard(module):
    """The stage baselines, the production-scale run and the raycast
    micro-benchmark, each alone in a fresh interpreter under the guard:
    neither jax nor mq3d_tpu; importing builds no reference library and
    sets no environment variable."""
    walk = _SCRIPT[_SCRIPT.index("names = "):_SCRIPT.index("for name in names")]
    script = _SCRIPT.replace(walk, f"names = [{module!r}]\n") + (
        "import os\n"
        "from mq3d_tpu_torch.tools import bench_reference_stages\n"
        "assert bench_reference_stages._conf_lib.lib is None\n"
        "assert bench_reference_stages._icp_lib.lib is None\n"
        "assert 'MQ3D_SUBSTEP_TIMING' not in os.environ\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO,
                          env={k: v for k, v in os.environ.items()
                               if k != "MQ3D_SUBSTEP_TIMING"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "1"


def test_stage_baselines_build_from_the_port_sources():
    """The stage baselines compile the port's own copies of the C++, and
    no slice-11 tool names the JAX build's native/ directory."""
    from mq3d_tpu_torch.tools import bench_reference_stages

    assert bench_reference_stages.CONF_SOURCE == REPO / "mq3d_tpu_torch/csrc/ref_confidence_cpu.cpp"
    assert bench_reference_stages.ICP_SOURCE == REPO / "mq3d_tpu_torch/csrc/ref_icp_cpu.cpp"
    for module in SLICE11_MODULES:
        path = REPO / (module.replace(".", "/") + ".py")
        assert "native/" not in path.read_text(), module


# Phase B's form is chosen in ops/tsdf.py alone (`_window_sums`, `_fuse_window`).
PHASE_B_CHOICE = {"_resolve_lookup", "_integrate_pairs", "_pairs_from_grid",
                  "integrate_window", "window_sums"}
# The XLA-order arithmetic lives in ops/fma.py: ops.tsdf holds none of it,
# under its old private names or its new ones.
ARITHMETIC = {"_fma", "_fma_plain", "_apply_pose", "_norm3", "_rotate_add", "_sqrt",
              "_to_i32", "_scalar", "fma", "fma_plain", "apply_pose", "norm3",
              "rotate_add", "sqrt_rn", "to_i32", "f32_scalar"}
PORT_MODULES = sorted(p.relative_to(REPO).as_posix()
                      for p in (REPO / "mq3d_tpu_torch").rglob("*.py"))


def boundary_breaches(path: str, source: str) -> list:
    """Imports and attribute reads in `source` (the port module `path`)
    that cross step 3's or the arithmetic's one home."""
    package = path[:-3].replace("/", ".").split(".")[:-1]
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            src = ".".join(base + ([node.module] if node.module else []))
            for alias in node.names:
                if src == "mq3d_tpu_torch.ops.tsdf" and alias.name in ARITHMETIC:
                    bad.append(f"arithmetic {alias.name} from ops.tsdf")
                if alias.name in PHASE_B_CHOICE and path != "mq3d_tpu_torch/ops/tsdf.py":
                    bad.append(f"Phase B's {alias.name} imported from {src}")
        elif (isinstance(node, ast.Attribute) and node.attr in PHASE_B_CHOICE
              and path != "mq3d_tpu_torch/ops/tsdf.py"):
            bad.append(f"Phase B's {node.attr} read as an attribute")
    return bad


@pytest.mark.parametrize("path", PORT_MODULES)
def test_step3_chunk_path_and_arithmetic_have_one_home(path):
    """No port module but ops/tsdf.py reaches Phase B's choice (the tile
    loop's parts, K5's two forms, `_resolve_lookup`), and none takes the
    XLA-order arithmetic from ops.tsdf: it comes from ops/fma.py."""
    assert boundary_breaches(path, (REPO / path).read_text()) == []


@pytest.mark.parametrize("line,path", [
    ("from mq3d_tpu_torch.ops.tsdf import _fma\n", "mq3d_tpu_torch/eval/metrics.py"),
    ("from mq3d_tpu_torch.ops.tsdf import _apply_pose, _norm3\n",
     "mq3d_tpu_torch/ops/odometry.py"),
    ("from .tsdf import fma\n", "mq3d_tpu_torch/ops/raycast.py"),
    ("from mq3d_tpu_torch.ops.tsdf_window import window_sums\n",
     "mq3d_tpu_torch/parallel/sharded.py"),
    ("from mq3d_tpu_torch.ops.tsdf import _resolve_lookup, _integrate_pairs\n",
     "mq3d_tpu_torch/parallel/sharded.py"),
    ("x = tsdf_ops._pairs_from_grid\n", "mq3d_tpu_torch/parallel/dryrun.py"),
])
def test_the_boundary_check_sees_an_old_import(line, path):
    """Each of the imports the check refuses, put back into its old module."""
    assert boundary_breaches(path, line + (REPO / path).read_text())

