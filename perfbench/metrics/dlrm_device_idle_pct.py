"""Share of DLRM-DCNv2's traced window in which the card ran no operation
(kernel, copy or set): 100 * (1 - busy / window)."""

LAYER = "device"
MOVES = "train_examples_per_s"


def read(ctx):
    return ctx.idle_pct()
