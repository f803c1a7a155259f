"""Self time of autograd's backward per step on DLRM-DCNv2: each
``train.backward`` span's device time less the ``embed.bwd`` intervals
inside it (the bags' take backward). What is left are the top MLP's, the
cross network's, the bottom MLP's and the loss's gradients, two thirds of
the step's products. The reader is ``backward_self_span_ms``'s
(DLRM-DCNv2 has no ``fm.bwd``)."""

from perfbench.metrics import backward_self_span_ms

LAYER = "tower and interaction (models/graph.py, models/common.py)"
MOVES = "train_examples_per_s"

read = backward_self_span_ms.read
