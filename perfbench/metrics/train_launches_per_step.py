"""Device kernels launched in the traced window, per optimizer step (per
card): what the fit loop and dispatch cost the host in launches."""

LAYER = "fit loop and dispatch (train/loop.py)"
MOVES = "train_examples_per_s"


def read(ctx):
    n = sum(1 for o in ctx.ops if o.cat == "kernel")
    return n / ctx.steps if n and ctx.steps else None
