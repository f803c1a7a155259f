"""Device resolution for the port's entry points.

Entry points default to ``"cuda"``. A caller that wants the CPU says so
(``device="cpu"``, as the tests do); a missing GPU raises here instead of
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when it names CUDA and no
    CUDA device is usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev
