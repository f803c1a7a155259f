"""``dfm_take_bwd``'s share of its roofline on DLRM-DCNv2: the least time
its bytes need at the memory's peak (``perfbench/kernels/
dlrm_take_bwd.py``: one launch a feature) over the device time of its
launches in the traced window."""

LAYER = "embedding (ops/embedding.py, ops/embedding_kernels.py, csrc/embedding.cu)"
MOVES = "train_examples_per_s"


def read(ctx):
    return ctx.roofline_pct("dlrm_take_bwd")
