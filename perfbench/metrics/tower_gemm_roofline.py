"""The step's matrix products' share of their roofline: the tower's
bfloat16 GEMMs, least time from shapes
(``perfbench/kernels/tower_gemm.py``) over the GEMM kernels' device time
in the window."""

LAYER = "tower and interaction (models/graph.py, models/common.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    return ctx.roofline_pct("tower_gemm")
