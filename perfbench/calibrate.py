"""Readings for a cell's limits: the program's first steps against the
reference, and the control and faults against the reference, over many
seeds in one process (one card).

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,13

One line a seed on standard output: the seed, the program's numbers, the
control's, each fault's (half of the batch left out; a state left
unchanged), the leaves that set them, and the program's and the
reference's norms of every leaf. The limits in
``perfbench/limits/<workload>.json`` are set from these readings; the
benchmark's own runs make none of them.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_readings(run, readings):
    """The control and the faults, each put in the program's place and
    read against the reference: the reference one precision below the
    configuration, half of the batch left out (the mean over the rest),
    and a state left unchanged. ``{case: (numbers, the leaves that set
    them)}``, the program's own readings under ``program``."""
    from perfbench.core import compare
    got = {"control_fp8": run.reference(quant=True),
           "fault_half_batch": run.reference(rows=slice(0, run.bs // 2))}
    got["fault_unchanged_state"] = dict(
        run.checked, change={k: 0.0 for k in run.checked["change"]})
    got["program"] = run.checked
    return {name: (compare.gaps(g, readings),
                   compare.worst_leaves(g, readings))
            for name, g in got.items()}


def readings(cell, seed: int, device: str = "cuda"):
    from perfbench.core import train_cell
    run = train_cell.Run(cell, seed=seed, device=device, t0=time.time())
    run.setup()
    run.free_program()
    ref = run.reference()
    out = {"seed": seed, "setup_s": run.setup_s,
           "leaves": {"reference": ref, "program": run.checked}}
    for name, (numbers, worst) in control_readings(run, ref).items():
        out[name] = numbers
        out[name + "_worst"] = worst
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from perfbench.core import registry
    cell = registry.Registry(ROOT).cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload,
                          **readings(cell, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
