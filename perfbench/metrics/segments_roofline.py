"""``dfm_segments``'s share of its roofline (``perfbench/kernels/
segments.py``) over the device time of its launches in the window."""

LAYER = "embedding (ops/embedding.py, ops/embedding_kernels.py, csrc/embedding.cu)"
MOVES = "train_examples_per_s"


def read(ctx):
    return ctx.roofline_pct("segments")
