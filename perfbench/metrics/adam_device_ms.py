"""Device time of the optimizer per step: the foreach kernels of
``train/optimizers.py``'s Adam (``multi_tensor_apply``), per step."""

LAYER = "optimizer (train/optimizers.py)"
MOVES = "train_examples_per_s"

MATCH = ("multi_tensor_apply",)


def read(ctx):
    return ctx.per_step_ms(ctx.kernels(MATCH))
