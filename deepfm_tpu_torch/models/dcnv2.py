"""DCN-v2: cross network (explicit feature crosses) + DNN tower.

Cross layers follow DCN-v2 (Wang et al., 2021):

    x_{l+1} = x_0 * (W_l x_l + b_l) + x_l          (full rank)
    x_{l+1} = x_0 * (U_l (V_l x_l) + b_l) + x_l    (low rank, cross_rank > 0)

The implementation is ``graph.GraphDCNv2``; this class keeps the public
name, as ``deepfm_tpu.models.dcnv2`` does.
"""

from __future__ import annotations

from .graph import GraphDCNv2


class DCNv2(GraphDCNv2):
    name = "dcnv2"
