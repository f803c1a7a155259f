"""``dfm_segments``'s share of its roofline on DLRM-DCNv2 (``perfbench/
kernels/dlrm_segments.py``: each feature's segments) over the device time
of its launches in the traced window."""

LAYER = "embedding (ops/embedding.py, ops/embedding_kernels.py, csrc/embedding.cu)"
MOVES = "train_examples_per_s"


def read(ctx):
    return ctx.roofline_pct("dlrm_segments")
