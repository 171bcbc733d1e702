"""The readings that a cell's limits are set from, in one process:

    python -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6]

For each of `--seeds`, the program's timed path (the cell's entry, one
warm step and then the steps up to the last call the check samples, as a
run's window drives them) is checked against the reference: these are the
lower readings.  For each of
`--control-seeds`, the reference computed in bfloat16 is put in the
program's place: the upper readings.  One JSON line per seed on standard
output.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark.run import cache_env

    cache_env()
    import torch

    from benchmark import core

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = core.load_manifest()
    cell = core.find_cell(manifest, args.workload)
    config = core.load_config(manifest, cell["config"])
    traffic = core.load_traffic(cell["traffic"])
    name = traffic["entry"]
    generator = core.load_part("generators", traffic["generator"])
    entry_mod = core.load_part("entries", name)
    reference = core.load_part("reference", name)
    dev = torch.device(args.device)
    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        session = generator.make(traffic, seed, dev)
        entry = entry_mod.Entry(session, config, dev, seed)
        entry.warm()
        entry.finish()
        outputs = entry.outputs()
        entry.free()
        del entry
        gc.collect()
        t1 = time.perf_counter()
        numbers = reference.check(session, config, outputs, dev, seed)
        t2 = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "program",
                          "numbers": numbers, "program_s": t1 - t0, "reference_s": t2 - t1}),
              flush=True)
        del outputs, session
        gc.collect()
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        session = generator.make(traffic, seed, dev)
        numbers = reference.control(session, config, dev, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "control",
                          "numbers": numbers, "seconds": time.perf_counter() - t0}), flush=True)
        del session
        gc.collect()
    found = core.forbidden_modules()
    if found:
        print(f"modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
