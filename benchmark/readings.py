"""The readings that a cell's limits are set from, on the card, in one
process: for each seed, the numbers compared of a short run of the
program at the cell's own load and sizes (benchmark.run's run, no trace),
and of the control, the plain reference in float8 in the program's place.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3
        [--seconds 4] [--what program,control]

`--what` may also name a fault of the cell's kind ("fault:half_batch",
the kind's FAULTS), read as the program's numbers with that fault under
its timed path. One JSON line per seed and side: {"seed", "side",
"numbers", "s"}. The benchmark's own runs never run the control or a
fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from benchmark import run


def program_numbers(spec, cell, seed, seconds, device, data=run.BENCH,
                    fault=None):
    """Every number the cell's kind computes for one short run of the
    program, with `fault` (a name in the kind's FAULTS) under its timed
    path."""
    hook = None
    if fault is not None:
        hook = run.load_kind(run.Cell(spec, cell, run.ROOT,
                                      Path(data))).FAULTS[fault]
    out = run.run_cell(spec, cell, seed, seconds, False, device=device,
                       data=data, t_start=time.perf_counter(),
                       raw_checks=True, program_hook=hook)
    return out["raw_checks"]


def control_numbers(spec, name, seed, device, data=run.BENCH):
    import torch
    cell = run.Cell(spec, name, run.ROOT, Path(data))
    return run.load_kind(cell).control(cell, seed, torch.device(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--what", default="program,control")
    args = ap.parse_args(argv)
    run.set_cache_dirs(run.ROOT)
    spec = run.load_spec()
    sides = args.what.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in sides:
            t = time.perf_counter()
            if side == "program" or side.startswith("fault:"):
                fault = side.split(":", 1)[1] if ":" in side else None
                nums = program_numbers(spec, args.workload, seed,
                                       args.seconds, "cuda", fault=fault)
            else:
                nums = control_numbers(spec, args.workload, seed, "cuda")
            print(json.dumps({"seed": seed, "side": side, "numbers": nums,
                              "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
