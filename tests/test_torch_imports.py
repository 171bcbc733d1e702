"""Import guard for mq3d_tpu_torch and chip_smoke.py.

The machine with the card has the standard library, torch, numpy and scipy,
but not jax, pandas, cv2, PIL, yaml or tqdm, and the port must not need the
JAX package.  In a fresh interpreter whose import system refuses those
names, every module of mq3d_tpu_torch and chip_smoke must import.
"""

import subprocess
import sys
from pathlib import Path

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


def test_guard_refuses_a_forbidden_import():
    """The guard itself works: a module importing yaml fails under it."""
    script = _SCRIPT.replace('names = ["chip_smoke"]', 'names = ["yaml"]')
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0 and "refused" in proc.stderr
