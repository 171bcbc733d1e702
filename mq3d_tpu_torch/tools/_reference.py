"""The build of the CPU reference baselines and a description of the host.

The two reference tools (``bench_reference_cpu``, ``bench_reference_raycast``)
compile their C++ sources (``mq3d_tpu_torch/csrc/ref_*_cpu.cpp``) with g++
on first use into ``<repo>/build/``, through the build steps the native IO
runtime uses (``kernels/_build.py``).  The sources are compiled with
``-march=native``, so the library's name hashes the host's CPU model and
instruction-set flags beside the compiler flags and the source: a build
directory copied to another machine is not loaded there.  A failed build
raises with g++'s output.
"""

from __future__ import annotations

import os
import platform
from pathlib import Path

from mq3d_tpu_torch.kernels._build import BUILD_DIR, build_into, run_tool, source_hash
from mq3d_tpu_torch.utils.native import find_gxx


def _cpuinfo(field: str) -> str:
    """The first `field` line of /proc/cpuinfo ("" where there is none)."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.split(":", 1)[0].strip() == field:
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def cpu_model() -> str:
    """The host CPU's model name (/proc/cpuinfo); where a virtual machine
    hides it ("unknown"), its vendor, family and model numbers."""
    name = _cpuinfo("model name")
    if name and name != "unknown":
        return name
    ids = [_cpuinfo(k) for k in ("vendor_id", "cpu family", "model")]
    if all(ids):
        return f"{ids[0]} family {ids[1]} model {ids[2]}"
    return platform.processor() or platform.machine()


def host_threads() -> int:
    """Hardware threads this process may run on."""
    return len(os.sched_getaffinity(0))


def host_cpu() -> dict:
    return {"cpu": cpu_model(), "threads": host_threads()}


def build_reference(source: Path, flags) -> Path:
    """Compile `source` with g++ and `flags` into
    build/lib<stem>_<hash>.so unless it is there already; returns its path."""
    flags = tuple(flags)
    key = source_hash(flags + (cpu_model(), _cpuinfo("flags")), [source])
    lib_path = BUILD_DIR / f"lib{source.stem}_{key}.so"
    if not lib_path.exists():
        gxx = find_gxx()
        build_into(lib_path, lambda tmp: run_tool(
            [gxx, *flags, str(source), "-o", str(tmp)], "g++"))
    return lib_path
