"""The optimizer's share of its roofline on DLRM-DCNv2: the least time its
bytes need at the memory's peak over the device time of the
``train.optimizer`` spans. Each optimized entry needs 20 bytes: its
float32 value, accumulator and gradient read, its value and accumulator
written; the entries are every table's touched rows (the span's
``unique_rows`` count) times K and the dense parameters (its
``dense_params``). A program whose span has no such counts reads None."""

from perfbench.metrics import _spans

LAYER = "optimizer (train/optimizers.py)"
MOVES = "train_examples_per_s"

BYTES_PER_ENTRY = 20


def read(ctx):
    least = busy = 0.0
    for s in ctx.spans:
        args = s.get("args") or {}
        if s["name"] != "train.optimizer" or "dev_dur" not in args:
            continue
        if "unique_rows" not in args or "dense_params" not in args:
            return None
        entries = args["unique_rows"] * ctx.shapes["dim"] \
            + args["dense_params"]
        least += BYTES_PER_ENTRY * entries / ctx.peaks["hbm_bytes_per_s"]
        busy += args["dev_dur"] / 1e6
    if busy <= 0:
        return None
    return 100.0 * least / busy
