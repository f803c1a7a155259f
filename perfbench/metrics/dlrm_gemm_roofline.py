"""The matrix products' share of their roofline on DLRM-DCNv2: the bottom
MLP's, the cross network's and the top MLP's bfloat16 products, least
time from shapes (``perfbench/kernels/dlrm_gemm.py``) over the GEMM
kernels' device time in the window."""

LAYER = "tower and interaction (models/graph.py, models/common.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    return ctx.roofline_pct("dlrm_gemm")
