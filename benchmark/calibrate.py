#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, one process
for many seeds: for each seed the program's set-up (whose first steps are
what a run compares), then the reference, the control (the reference in
the next precision below the configuration's, in the program's place) and
each planted fault, each read against the reference.

    python benchmark/calibrate.py --workload grid_sd15.sds_train \
        --seeds 11,12,13 --control 1 --faults half_batch

One JSON line a seed on standard output: {"seed", "program", "control",
"<fault>"}, each a dict of the numbers the cell compares. The benchmark's
own runs never run this."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def calibrate(workload: str, seeds, control: bool, faults, device="cuda",
              cell=None):
    import torch

    from benchkit import cells

    cell = cell or cells.load_cell(workload)
    mod = cells.runner(cell.mix["runner"])
    for seed in seeds:
        t0 = time.perf_counter()
        r = mod.Run(cell, seed, device=device)
        if getattr(r, "calibration_units", 0):
            r.steps(n=r.calibration_units)   # answers to compare
        prog = r.program_record()
        r.release()
        ref = r.reference()
        line = {"seed": seed, "program": mod.readings(prog, ref)}
        if hasattr(mod, "leaf_gaps"):
            line["program_leaves"] = mod.leaf_gaps(prog, ref)
        if control:
            ctl = r.reference("control")
            line["control"] = mod.readings(ctl, ref)
            if hasattr(mod, "leaf_gaps"):
                line["control_leaves"] = mod.leaf_gaps(ctl, ref)
        for fault in faults:
            bad = r.reference(fault=fault)
            line[fault] = mod.readings(bad, ref)
            if hasattr(mod, "leaf_gaps"):
                line[fault + "_leaves"] = mod.leaf_gaps(bad, ref)
        line["seconds"] = time.perf_counter() - t0
        r.close()
        del r
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        yield line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--faults", default="")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    faults = [f for f in a.faults.split(",") if f]
    for line in calibrate(a.workload, seeds, bool(a.control), faults):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
