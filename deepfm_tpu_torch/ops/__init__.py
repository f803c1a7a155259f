from . import embedding, fm, fused_fm  # noqa: F401
