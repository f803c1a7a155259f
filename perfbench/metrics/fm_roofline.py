"""The fused FM kernels' share of their roofline: forward and backward
(``perfbench/kernels/fm_fwd.py``, ``fm_bwd.py``) together, least time
over device time in the window. DeepFM only: the graphs without the FM
block launch neither."""

LAYER = "FM (ops/fused_fm.py, csrc/fused_fm.cu)"
MOVES = "train_examples_per_s"

KERNELS = ("fm_fwd", "fm_bwd")


def read(ctx):
    t = sum(ctx.seconds(ctx.kernels(ctx.kernel(k).MATCH)) for k in KERNELS)
    least = sum(ctx.least_seconds(k) for k in KERNELS) * ctx.steps
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
