"""The benchmark of ``deepfm_tpu_torch``: one run of one cell.

    python3 perfbench/run.py --workload W --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names its configuration and traffic mix, which are found by
name under ``perfbench/``. The run makes its rows and weights on the card
from ``--seed``, sets up and checks the program's first steps, measures
for ``--seconds`` (``--trace 0``: the end-to-end metrics) or traces a
window (``--trace 1``: the per-layer metrics), compares the first steps
with the plain reference, prints the numbers compared on standard error
and, as the last line of standard output, one JSON object.
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

#: Top-level modules that no run may load (the JAX package included).
FORBIDDEN = ("jax", "jaxlib", "flax", "deepfm_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser("perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def emit(result, lines) -> int:
    bad = forbidden_modules()
    if bad:
        return fail(f"modules loaded that the port must not load: {bad}", 5)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    try:
        from perfbench.core import registry
        import deepfm_tpu_torch  # noqa: F401
    except ImportError as exc:
        return fail(f"the checkout lacks the program ({exc})", 3)
    import torch
    cell = registry.Registry(ROOT).cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available():
        return fail("no CUDA device", 2)
    if torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} cards, "
                    f"{torch.cuda.device_count()} visible", 2)
    if chips > 1:
        return fail("cells on several cards are not supported yet", 2)
    from perfbench.core import process
    result, lines = process.run_process(
        cell, seed=args.seed, seconds=args.seconds, trace=args.trace,
        device="cuda", t0=T0)
    return emit(result, lines)


if __name__ == "__main__":
    sys.exit(main())
