"""The port's fused FM forward (``deepfm_tpu_torch.ops.fused_fm``) against
the JAX package's Pallas kernel and its plain reference.

On the CPU the port's ``fused_fm`` takes its plain version
(``reference_fm``); the JAX side runs the Pallas kernel body through the
Pallas interpreter, as ``tests/test_pallas_fm.py`` does. The CUDA kernel
itself runs only on the card (``chip_smoke.py`` holds it against
``reference_fm`` there). Inputs come from a numpy seed and go to both
frameworks as the same values.

The backward: ``FusedFM``'s gradients (the CPU path runs the autograd
function with ``reference_fm_bwd``) against ``jax.vjp`` of the Pallas
kernel's custom VJP, in interpret mode, with the cotangents' dtypes.

Also here: the wrappers' input checks (they run before any launch, so the
CPU can reach them), the launch counters, the backward's C binding, and the
kernel build protocol of ``deepfm_tpu_torch._native`` driven by a stand-in
compiler.
"""

import ctypes
import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.ops import fm as jax_fm
from deepfm_tpu.ops import pallas_fm
from deepfm_tpu_torch import _native
from deepfm_tpu_torch.ops import fm as torch_fm
from deepfm_tpu_torch.ops import fused_fm as ffm

torch.set_num_threads(1)

# Float32 sums in another order than XLA's: the tolerance of
# tests/test_pallas_fm.py. bfloat16 inputs are converted to float32 after
# the load on both sides (exactly), so the same tolerance holds for them,
# well inside the bf16 band of test_bf16_residuals_and_grad_dtypes
# (rtol/atol 0.05).
RTOL, ATOL = 1e-4, 1e-3

_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(b, f, k, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(b, f)).astype(np.float32)
    vals = rng.normal(size=(b, f)).astype(np.float32)
    xv = rng.normal(size=(b, f, k)).astype(np.float32)
    return w, vals, xv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [4, 32, 48])
@pytest.mark.parametrize("f", [3, 39])
@pytest.mark.parametrize("b", [1, 5, 128, 130])
def test_fused_fm_matches_jax(b, f, k, dtype):
    arrays = _inputs(b, f, k, seed=b * 1000 + f * 10 + k)
    tw, tvals, txv = (torch.from_numpy(a).to(_TORCH_DT[dtype]) for a in arrays)
    jw, jvals, jxv = (jnp.asarray(a, _JAX_DT[dtype]) for a in arrays)

    got = ffm.fused_fm(tw, tvals, txv)
    assert got.dtype == torch.float32 and got.shape == (b,)
    want = np.asarray(pallas_fm.fused_fm(jw, jvals, jxv, True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ffm.reference_fm(tw, tvals, txv).numpy(),
        np.asarray(pallas_fm.reference_fm(jw, jvals, jxv)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [1, 39])
@pytest.mark.parametrize("k", [8, 33, 64])
@pytest.mark.parametrize("b", [1, 3, 257])
def test_fused_fm_vector_and_scalar_path_shapes_match_jax(b, k, f, dtype):
    """The shapes that pick the CUDA forward's paths (K = 8 and 64 take its
    16-byte vector path, K = 33 its scalar path; F = 1 leaves most of a
    row's threads without a chunk; B = 257 ends in a partial block):
    ``fused_fm`` against the Pallas kernel in interpret mode.

    RTOL and ATOL as above, plus the rounding of float32 sums in another
    order where they cancel: at F = 39, K = 64 the two halves of y_v reach
    ~2,500 and cancel to y ~ 1 in some rows, where two sum orders differ by
    a few ulps of 2,500 (~1e-3), so a row may also differ by 2 eps
    sqrt(F K) times the magnitude of its terms."""
    arrays = _inputs(b, f, k, seed=7 * b + 3 * k + f)
    tw, tvals, txv = (torch.from_numpy(a).to(_TORCH_DT[dtype]) for a in arrays)
    jw, jvals, jxv = (jnp.asarray(a, _JAX_DT[dtype]) for a in arrays)
    got = ffm.fused_fm(tw, tvals, txv)
    assert got.dtype == torch.float32 and got.shape == (b,)
    want = np.asarray(pallas_fm.fused_fm(jw, jvals, jxv, True))
    x = txv.double().numpy()
    terms = (np.abs(tw.double().numpy() * tvals.double().numpy()).sum(1)
             + 0.5 * (x.sum(1) ** 2).sum(1) + 0.5 * (x * x).sum((1, 2)))
    rounding = 2 * np.finfo(np.float32).eps * np.sqrt(f * k) * terms
    assert np.all(np.abs(got.numpy() - want)
                  <= ATOL + RTOL * np.abs(want) + rounding)


@pytest.mark.parametrize("b,f,k", [(8, 5, 4), (64, 39, 32)])
def test_fm_interaction_matches_jax(b, f, k):
    _, _, xv = _inputs(b, f, k, seed=3)
    np.testing.assert_allclose(
        torch_fm.fm_interaction(torch.from_numpy(xv)).numpy(),
        np.asarray(jax_fm.fm_interaction(jnp.asarray(xv))),
        rtol=RTOL, atol=ATOL)


def test_fused_equals_first_order_plus_interaction():
    w, vals, xv = (torch.from_numpy(a) for a in _inputs(64, 7, 8, seed=4))
    want = torch.sum(w * vals, dim=1) + torch_fm.fm_interaction(xv)
    torch.testing.assert_close(ffm.fused_fm(w, vals, xv), want,
                               rtol=RTOL, atol=ATOL)


def test_cpu_calls_launch_nothing():
    before = ffm.fused_fm.launches
    w, vals, xv = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(16, 5, 4))
    ffm.fused_fm(w, vals, xv).sum().backward()
    assert ffm.fused_fm.launches == before == 0
    assert ffm.fused_fm.bwd_launches == 0


def test_other_devices_raise():
    w = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ffm.fused_fm(w, w, torch.empty((2, 3, 4), device="meta"))


# ---------------------------------------------------------------------------
# The CUDA wrapper's input checks (run before any launch)
# ---------------------------------------------------------------------------

def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("w,vals,xv,exc,match", [
    (_t(4, 3), _t(4, 3), _t(4, 3, 8), None, None),
    (_t(4, 3), _t(4, 2), _t(4, 3, 8), ValueError, "expects w, vals"),
    (_t(4, 3), _t(4, 3), _t(4, 2, 8), ValueError, "expects w, vals"),
    (_t(4, 3), _t(4, 3), _t(4, 3), ValueError, "expects w, vals"),
    (_t(4, 3), _t(4, 3, dtype=torch.bfloat16), _t(4, 3, 8), TypeError,
     "all float32 or all"),
    (_t(4, 3, dtype=torch.float16), _t(4, 3, dtype=torch.float16),
     _t(4, 3, 8, dtype=torch.float16), TypeError, "all float32 or all"),
    (_t(4, 3), _t(4, 3), _t(4, 8, 3).transpose(1, 2), ValueError,
     "contiguous"),
])
def test_kernel_input_checks(w, vals, xv, exc, match):
    if exc is None:
        ffm._check_kernel_inputs(w, vals, xv)
    else:
        with pytest.raises(exc, match=match):
            ffm._check_kernel_inputs(w, vals, xv)


@pytest.mark.parametrize("g,exc,match", [
    (_t(4), None, None),
    (_t(3), ValueError, "float32 cotangent"),
    (_t(4, dtype=torch.bfloat16), ValueError, "float32 cotangent"),
    (_t(8)[::2], ValueError, "float32 cotangent"),
])
def test_bwd_kernel_input_checks(g, exc, match):
    w, vals, xv = _t(4, 3), _t(4, 3), _t(4, 3, 8)
    if exc is None:
        ffm._check_bwd_inputs(g, w, vals, xv)
    else:
        with pytest.raises(exc, match=match):
            ffm._check_bwd_inputs(g, w, vals, xv)
    with pytest.raises(ValueError, match="expects w, vals"):
        ffm._check_bwd_inputs(_t(4), w, _t(4, 2), xv)


# ---------------------------------------------------------------------------
# Backward: FusedFM's gradients against the JAX custom VJP
# ---------------------------------------------------------------------------

# The backward is elementwise after one float32 sum over F, in the same
# order on both sides up to XLA's reduction order: float32 cotangents agree
# to 1e-5. bfloat16 cotangents are rounded from float32 on both sides; a
# value within float32 rounding of a bf16 rounding boundary can land one
# bf16 ulp apart (2^-8 relative), hence rtol 2^-7 for them.
GRAD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,f,k", [(1, 3, 4), (5, 39, 32), (64, 8, 8),
                                   (130, 39, 48)])
def test_fused_fm_grads_match_jax_vjp(b, f, k, dtype):
    arrays = _inputs(b, f, k, seed=b + f + k)
    g = np.random.default_rng(7).normal(size=(b,)).astype(np.float32)
    tw, tvals, txv = (torch.from_numpy(a).to(_TORCH_DT[dtype])
                      .requires_grad_() for a in arrays)
    y = ffm.fused_fm(tw, tvals, txv)
    got = torch.autograd.grad(y, (tw, tvals, txv), torch.from_numpy(g))

    jarrays = tuple(jnp.asarray(a, _JAX_DT[dtype]) for a in arrays)
    _, vjp = jax.vjp(lambda *a: pallas_fm.fused_fm(*a, True), *jarrays)
    want = vjp(jnp.asarray(g))
    for name, t, gt, wt in zip(("dw", "dvals", "dxv"), (tw, tvals, txv),
                               got, want):
        assert gt.dtype == t.dtype == _TORCH_DT[dtype], name
        assert str(wt.dtype) == dtype, name
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(wt, np.float32),
                                   err_msg=name, **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_bwd_equals_autograd_of_reference(dtype):
    """The plain backward is the derivative of the plain forward. Both in
    float32 then rounded to the primal dtype once (float32: exact up to sum
    order)."""
    arrays = _inputs(16, 7, 5, seed=11)
    tw, tvals, txv = (torch.from_numpy(a).to(_TORCH_DT[dtype])
                      .requires_grad_() for a in arrays)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(16,))
                         .astype(np.float32))
    want = torch.autograd.grad(ffm.reference_fm(tw, tvals, txv),
                               (tw, tvals, txv), g)
    got = ffm.reference_fm_bwd(g, tw.detach(), tvals.detach(), txv.detach())
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype == _TORCH_DT[dtype]
        torch.testing.assert_close(gt.float(), wt.float(),
                                   **GRAD_TOL[dtype])


def test_fused_fm_saves_primals_as_given_and_skips_unneeded_grads():
    """Residuals keep the primals' dtype (no float32 copies), and a grad
    nobody asked for comes back as None."""
    w, vals, xv = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(4, 3, 8))
    xv.requires_grad_()
    y = ffm.fused_fm(w, vals, xv)
    assert y.dtype == torch.float32
    saved = [t.dtype for t in y.grad_fn.saved_tensors]
    assert saved == [torch.bfloat16] * 3
    dxv, = torch.autograd.grad(y.sum(), (xv,))
    assert dxv.dtype == torch.bfloat16 and dxv.shape == (4, 3, 8)
    assert ffm.fused_fm.bwd_launches == 0  # the CPU launches nothing


def test_bwd_binder_is_declared():
    """The C signature of dfm_fused_fm_bwd (12 arguments, int return) is
    declared on the library the forward lives in."""
    class FakeFn:
        argtypes = restype = None

    class FakeLib:
        dfm_fused_fm_fwd = FakeFn()
        dfm_fused_fm_bwd = FakeFn()

    lib = FakeLib()
    _native._BINDERS["fused_fm"](lib)
    bwd = lib.dfm_fused_fm_bwd
    assert len(bwd.argtypes) == 12 and bwd.restype is ctypes.c_int
    assert bwd.argtypes[:7] == [ctypes.c_void_p] * 7
    assert bwd.argtypes[7] is ctypes.c_int64
    assert bwd.argtypes[-1] is ctypes.c_void_p


# ---------------------------------------------------------------------------
# Kernel build protocol (_native), with a stand-in for nvcc
# ---------------------------------------------------------------------------

@pytest.fixture
def build_env(tmp_path, monkeypatch):
    """Private csrc/ and _build/ dirs, a fresh library cache and a PATH with
    nothing but ``bin/`` (where a test may put a fake nvcc)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in _native._BINDERS:  # a stand-in source per kernel library
        (csrc / f"{name}.cu").write_text(f"// {name} v1\n")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    monkeypatch.setattr(_native, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_native, "_libs", {})
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    return tmp_path


def _fake_nvcc(bindir, body):
    path = bindir / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


def test_library_path_keyed_on_source(build_env):
    first = _native.library_path("fused_fm")
    assert first.startswith(_native.BUILD_DIR)
    assert first == _native.library_path("fused_fm")
    (build_env / "csrc" / "fused_fm.cu").write_text("// kernel v2\n")
    assert _native.library_path("fused_fm") != first


def test_missing_nvcc_raises(build_env):
    with pytest.raises(_native.KernelBuildError, match="nvcc not found"):
        _native.build()
    with pytest.raises(_native.KernelBuildError):
        _native.load("fused_fm")


def test_failed_compile_raises_with_compiler_output(build_env):
    _fake_nvcc(build_env / "bin", 'echo "error: no sm_90a here"; exit 2\n')
    with pytest.raises(_native.KernelBuildError, match="no sm_90a here"):
        _native.build(["fused_fm"])
    assert not os.path.exists(_native.library_path("fused_fm"))
    leftovers = os.listdir(_native.BUILD_DIR)
    assert leftovers == [], leftovers


def test_build_installs_library_once(build_env):
    # The stand-in writes its -o argument, as nvcc would.
    _fake_nvcc(build_env / "bin", 'while [ "$1" != "-o" ]; do shift; done\n'
               'echo lib > "$2"; echo called >> "$0.calls"\n')
    _native.build()
    for name in _native._BINDERS:
        assert os.path.exists(_native.library_path(name)), name
    _native.build()  # already built: nvcc is not run again
    calls = (build_env / "bin" / "nvcc.calls").read_text().split()
    assert calls == ["called"] * len(_native._BINDERS)  # one per source


def test_check_raises_on_cuda_error():
    _native.check(0, "fused_fm")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _native.check(9, "fused_fm")
