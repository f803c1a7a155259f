"""Fused FM: first-order + second-order interaction, forward and backward.

The counterpart of ``deepfm_tpu/ops/pallas_fm.py``. Per row b:

    y[b] = sum_f w[b,f]*vals[b,f]
         + 0.5 * sum_k [ (sum_f xv[b,f,k])^2 - sum_f xv[b,f,k]^2 ]

and, for the float32 cotangent g [B] of y,

    dw = vals*g,  dvals = w*g,  dxv = (sum_f xv - xv)*g

``fused_fm`` goes through the autograd function :class:`FusedFM` on every
device, so saved tensors and gradient types are the same on the CPU as on
the card. What each pass runs depends on where its tensors lie: on the CPU
the plain versions ``reference_fm`` / ``reference_fm_bwd`` (what the tests
compare with the JAX package); on a CUDA tensor the hand-written kernels of
``csrc/fused_fm.cu`` (one warp per row, float32 sums; see the source for
their bounds and design), or an exception. There is no fallback on the
card.
"""

from __future__ import annotations

import threading

import torch

from .. import _native
from ..obs import trace as trace_lib

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


def reference_fm_bwd(g: torch.Tensor, w: torch.Tensor, vals: torch.Tensor,
                     xv: torch.Tensor):
    """Plain-torch version of the fused backward (``pallas_fm._bwd_kernel``).
    g: [B] -> (dw, dvals [B,F], dxv [B,F,K]), computed in float32 and each
    cast to its primal's dtype."""
    g = g.float()
    x = xv.float()
    s = torch.sum(x, dim=1, keepdim=True)
    dw = (vals.float() * g[:, None]).to(w.dtype)
    dvals = (w.float() * g[:, None]).to(vals.dtype)
    dxv = ((s - x) * g[:, None, None]).to(xv.dtype)
    return dw, dvals, dxv


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


def _check_bwd_inputs(g: torch.Tensor, w: torch.Tensor, vals: torch.Tensor,
                      xv: torch.Tensor) -> None:
    _check_kernel_inputs(w, vals, xv)
    if g.shape != w.shape[:1] or g.dtype != torch.float32 \
            or g.device != w.device or not g.is_contiguous():
        raise ValueError(
            f"the CUDA fused_fm backward takes a contiguous float32 "
            f"cotangent [B] on {w.device}; got {tuple(g.shape)} {g.dtype} "
            f"on {g.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _count(name: str) -> None:
    with _count_lock:
        setattr(fused_fm, name, getattr(fused_fm, name) + 1)


def _launch_fwd(w: torch.Tensor, vals: torch.Tensor,
                xv: torch.Tensor) -> torch.Tensor:
    _check_kernel_inputs(w, vals, xv)
    b, f = w.shape
    k = xv.shape[2]
    out = torch.empty((b,), dtype=torch.float32, device=w.device)
    if b == 0:
        return out
    lib = _native.load("fused_fm")
    with torch.cuda.device(w.device):
        err = lib.dfm_fused_fm_fwd(
            w.data_ptr(), vals.data_ptr(), xv.data_ptr(), out.data_ptr(),
            b, f, k, _KERNEL_DTYPES[w.dtype], _stream(w.device))
    _native.check(err, "fused_fm forward")
    _count("launches")
    return out


def _launch_bwd(g: torch.Tensor, w: torch.Tensor, vals: torch.Tensor,
                xv: torch.Tensor):
    _check_bwd_inputs(g, w, vals, xv)
    b, f = w.shape
    k = xv.shape[2]
    dw, dvals, dxv = (torch.empty_like(t) for t in (w, vals, xv))
    if b == 0:
        return dw, dvals, dxv
    lib = _native.load("fused_fm")
    with torch.cuda.device(w.device):
        err = lib.dfm_fused_fm_bwd(
            g.data_ptr(), w.data_ptr(), vals.data_ptr(), xv.data_ptr(),
            dw.data_ptr(), dvals.data_ptr(), dxv.data_ptr(), b, f, k,
            _KERNEL_DTYPES[w.dtype], _stream(w.device))
    _native.check(err, "fused_fm backward")
    _count("bwd_launches")
    return dw, dvals, dxv


class FusedFM(torch.autograd.Function):
    """``pallas_fm.fused_fm``'s custom VJP. The residuals are ``w``, ``vals``
    and ``xv`` as given (bfloat16 stays bfloat16: no float32 copies), and
    each cotangent comes back in its primal's dtype."""

    @staticmethod
    def forward(ctx, w, vals, xv):
        ctx.save_for_backward(w, vals, xv)
        if w.device.type == "cpu":
            return reference_fm(w, vals, xv)
        return _launch_fwd(w, vals, xv)

    @staticmethod
    def backward(ctx, g):
        with trace_lib.span("fm.bwd", device=g.device):
            w, vals, xv = ctx.saved_tensors
            g = g.float().contiguous()
            if w.device.type == "cpu":
                grads = reference_fm_bwd(g, w, vals, xv)
            else:
                grads = _launch_bwd(g, w, vals, xv)
        return tuple(d if need else None
                     for d, need in zip(grads, ctx.needs_input_grad))


def fused_fm(w: torch.Tensor, vals: torch.Tensor,
             xv: torch.Tensor) -> torch.Tensor:
    """Fused y_w + y_v. w, vals: [B,F]; xv: [B,F,K] -> [B] float32.

    CPU tensors take the plain versions; CUDA tensors launch the forward
    kernel (counted in ``fused_fm.launches``) and, when autograd reaches
    it, the backward kernel (``fused_fm.bwd_launches``), or raise."""
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_fm runs on cpu or cuda, not {w.device}")
    return FusedFM.apply(w, vals, xv)


fused_fm.launches = 0
fused_fm.bwd_launches = 0
