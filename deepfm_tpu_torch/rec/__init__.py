"""Retrieval→ranking cascade (port of ``deepfm_tpu.rec``): the candidate
index over twin-tower item embeddings (:mod:`.index`) and the two-stage
serving engine that composes retrieve→rank over the publish/hot-swap
machinery (:mod:`.cascade`)."""

from .index import CandidateIndex  # noqa: F401
