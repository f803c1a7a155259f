"""Observability plane (the port's copy of ``deepfm_tpu.obs``): span
tracing and one metrics registry, stdlib-only."""

from . import metrics, trace  # noqa: F401
