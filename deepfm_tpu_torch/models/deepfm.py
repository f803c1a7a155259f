"""DeepFM: bias + first-order + FM second-order + DNN tower.

    y = FM_B + sum_f(W[ids]*vals) + FM(xv) + DNN(flatten(xv)),  pred = sigmoid(y)

The implementation is ``graph.GraphDeepFM``; this class keeps the public
name, as ``deepfm_tpu.models.deepfm`` does.
"""

from __future__ import annotations

from .graph import GraphDeepFM


class DeepFM(GraphDeepFM):
    name = "deepfm"
