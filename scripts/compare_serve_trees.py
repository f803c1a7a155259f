#!/usr/bin/env python3
"""Serve latency of this checkout against another checkout of the port, on
one GPU: ``chip_smoke.py``'s serve phase (a seeded DeepFM at the reference
width published and served by ``ServingEngine.serve_latest`` to 8 client
threads, 384 requests, every response checked against the plain forward)
run in fresh processes, in turns baseline, this, this, baseline.

    git archive <rev> | tar -x -C _archive/parent
    python3 scripts/compare_serve_trees.py --baseline _archive/parent

Each process builds its checkout's kernels, then runs the serve phase
``--repeats`` times and prints its ``serve:`` lines (p50, p99, requests/s,
flushes). The card's name and power limit come first. Exits non-zero
without a CUDA device or when a serve phase fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CHILD = """
import os, shutil, sys, tempfile
tree = sys.argv[1]
sys.path.insert(0, tree)
import torch
import chip_smoke as cs
from deepfm_tpu_torch import _native
from deepfm_tpu_torch.config import Config
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
_native.build()
work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=tree)
try:
    for _ in range(int(sys.argv[2])):
        cs.serve_phase(work, Config(), torch.device("cuda"))
finally:
    shutil.rmtree(work, ignore_errors=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="root of the other checkout (holds chip_smoke.py)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="serve phases per process")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_serve_trees: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    base = os.path.abspath(args.baseline)
    for label, tree in (("baseline", base), ("this", ROOT), ("this", ROOT),
                        ("baseline", base)):
        res = subprocess.run(
            [sys.executable, "-c", CHILD, tree, str(args.repeats)],
            cwd=tree, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("serve:"):
                print(f"{label} ({tree}): {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
