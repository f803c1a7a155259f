"""Device time of the embedding layer's backward per step: the segments
build (``dfm_segments``) and the take backward (``dfm_take_bwd``) of the
dense lookups. The forward gathers run through PyTorch's generic gather
kernels, which a device-only trace cannot tell from the feed's gathers of
batch rows, so they are not counted here."""

LAYER = "embedding (ops/embedding.py, ops/embedding_kernels.py, csrc/embedding.cu)"
MOVES = "train_examples_per_s"

MATCH = ("segments_kernel", "take_bwd")


def read(ctx):
    return ctx.per_step_ms(ctx.kernels(MATCH))
