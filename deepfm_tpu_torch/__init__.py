"""deepfm_tpu_torch: the PyTorch and CUDA port of ``deepfm_tpu`` for an
NVIDIA H100.

The module layout mirrors ``deepfm_tpu`` so each counterpart is easy to
find. This package imports torch, numpy and the standard library only: it
never imports jax, orbax or anything of ``deepfm_tpu``, and keeps its own
copy of what it needs (``config``, ``obs``, the serving engine).

Entry points take an explicit ``device`` that defaults to ``"cuda"``; the
CPU is used only when a caller passes ``device="cpu"`` (the tests do). The
TPU package's one Pallas kernel on the serving path, the fused FM forward,
is a hand-written CUDA kernel here (``csrc/fused_fm.cu``), built with nvcc
at first use into ``_build/``.
"""

__version__ = "0.1.0"

from .config import Config, parse_args  # noqa: F401
