"""Fused FM forward: first-order + second-order interaction in one pass.

The counterpart of ``deepfm_tpu/ops/pallas_fm.py``. Per row b:

    y[b] = sum_f w[b,f]*vals[b,f]
         + 0.5 * sum_k [ (sum_f xv[b,f,k])^2 - sum_f xv[b,f,k]^2 ]

``fused_fm`` dispatches on where its tensors lie. On the CPU it computes
``reference_fm``, the plain version the tests compare with the JAX package.
On a CUDA tensor it launches the hand-written kernel in
``csrc/fused_fm.cu`` (one warp per row, float32 sums; see the source for
its bound and design) or raises: there is no fallback on the card.

This slice is the forward pass only. The TPU package's custom VJP
(``pallas_fm._bwd_kernel``) is ported with the training slice; until then
a CUDA call whose inputs require grad raises instead of training through a
different path.
"""

from __future__ import annotations

import threading

import torch

from .. import _native

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def reference_fm(w: torch.Tensor, vals: torch.Tensor,
                 xv: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of the fused forward (``pallas_fm.reference_fm``).
    w, vals: [B,F]; xv: [B,F,K]; any float dtype, summed in float32 -> [B]."""
    y_w = torch.sum(w.float() * vals.float(), dim=1)
    xv = xv.float()
    s = torch.sum(xv, dim=1)
    y_v = 0.5 * torch.sum(s * s, dim=1) - 0.5 * torch.sum(xv * xv, dim=(1, 2))
    return y_w + y_v


def _check_kernel_inputs(w: torch.Tensor, vals: torch.Tensor,
                         xv: torch.Tensor) -> None:
    if w.dim() != 2 or xv.dim() != 3 or vals.shape != w.shape \
            or xv.shape[:2] != w.shape:
        raise ValueError(
            f"fused_fm expects w, vals [B,F] and xv [B,F,K]; got "
            f"{tuple(w.shape)}, {tuple(vals.shape)}, {tuple(xv.shape)}")
    if not (w.device == vals.device == xv.device):
        raise ValueError(
            f"fused_fm inputs on different devices: {w.device}, "
            f"{vals.device}, {xv.device}")
    if not (w.dtype == vals.dtype == xv.dtype) or w.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            "the CUDA fused_fm kernel takes w, vals and xv all float32 or all "
            f"bfloat16; got {w.dtype}, {vals.dtype}, {xv.dtype}")
    if not (w.is_contiguous() and vals.is_contiguous()
            and xv.is_contiguous()):
        raise ValueError("the CUDA fused_fm kernel needs contiguous inputs")
    if torch.is_grad_enabled() and (w.requires_grad or vals.requires_grad
                                    or xv.requires_grad):
        raise NotImplementedError(
            "fused_fm on CUDA is forward-only in this slice: its backward "
            "kernel (pallas_fm._bwd_kernel's port) comes with the training "
            "slice")


def fused_fm(w: torch.Tensor, vals: torch.Tensor,
             xv: torch.Tensor) -> torch.Tensor:
    """Fused y_w + y_v. w, vals: [B,F]; xv: [B,F,K] -> [B] float32.

    CPU tensors take :func:`reference_fm`; CUDA tensors launch the kernel
    (counted in ``fused_fm.launches``) or raise."""
    if w.device.type == "cpu":
        return reference_fm(w, vals, xv)
    if w.device.type != "cuda":
        raise ValueError(f"fused_fm runs on cpu or cuda, not {w.device}")
    _check_kernel_inputs(w, vals, xv)
    b, f = w.shape
    k = xv.shape[2]
    out = torch.empty((b,), dtype=torch.float32, device=w.device)
    if b == 0:
        return out
    lib = _native.load("fused_fm")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.dfm_fused_fm_fwd(
            w.data_ptr(), vals.data_ptr(), xv.data_ptr(), out.data_ptr(),
            b, f, k, _KERNEL_DTYPES[w.dtype], stream)
    _native.check(err, "fused_fm")
    with _count_lock:
        fused_fm.launches += 1
    return out


fused_fm.launches = 0
