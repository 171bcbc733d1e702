"""One run of a benchmark cell on the card:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks beside their limits as the last lines of standard error
and the result as one JSON object on the last line of standard output.
Exits non-zero, with no result, when the cards the cell asks for are
missing or when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_CHECKOUT = Path(__file__).resolve().parent.parent
_CACHE = _CHECKOUT / "build" / "bench_cache"


def cache_env() -> None:
    """Every compile cache at a fixed path inside the checkout, so only a
    checkout's first run builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(_CACHE / sub)
        (_CACHE / sub).mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    from benchmark import core

    try:
        result = core.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START)
    except core.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    found = core.forbidden_modules()
    if found:
        print(f"no result: modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
