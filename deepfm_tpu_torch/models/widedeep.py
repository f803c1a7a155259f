"""Wide&Deep: linear wide part + DNN tower (no FM interaction term).

    y = b + wide(ids, vals) + DNN(xv)

The implementation is ``graph.GraphWideDeep``; this class keeps the public
name, as ``deepfm_tpu.models.widedeep`` does.
"""

from __future__ import annotations

from .graph import GraphWideDeep


class WideDeep(GraphWideDeep):
    name = "widedeep"
