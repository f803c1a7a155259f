"""The port's fused FM forward (``deepfm_tpu_torch.ops.fused_fm``) against
the JAX package's Pallas kernel and its plain reference.

On the CPU the port's ``fused_fm`` takes its plain version
(``reference_fm``); the JAX side runs the Pallas kernel body through the
Pallas interpreter, as ``tests/test_pallas_fm.py`` does. The CUDA kernel
itself runs only on the card (``chip_smoke.py`` holds it against
``reference_fm`` there). Inputs come from a numpy seed and go to both
frameworks as the same values.

Also here: the wrapper's input checks (they run before any launch, so the
CPU can reach them), the launch counter, and the kernel build protocol of
``deepfm_tpu_torch._native`` driven by a stand-in compiler.
"""

import os
import stat

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
    w, vals, xv = (torch.from_numpy(a) for a in _inputs(16, 5, 4))
    ffm.fused_fm(w, vals, xv)
    assert ffm.fused_fm.launches == before == 0


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


def test_inputs_requiring_grad_raise_not_fall_back():
    """Forward only in this slice: a grad-requiring call must raise, not
    train through the plain version."""
    xv = _t(4, 3, 8).requires_grad_()
    with pytest.raises(NotImplementedError, match="backward kernel"):
        ffm._check_kernel_inputs(_t(4, 3), _t(4, 3), xv)
    with torch.no_grad():
        ffm._check_kernel_inputs(_t(4, 3), _t(4, 3), xv)


# ---------------------------------------------------------------------------
# Kernel build protocol (_native), with a stand-in for nvcc
# ---------------------------------------------------------------------------

@pytest.fixture
def build_env(tmp_path, monkeypatch):
    """Private csrc/ and _build/ dirs, a fresh library cache and a PATH with
    nothing but ``bin/`` (where a test may put a fake nvcc)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fused_fm.cu").write_text("// kernel v1\n")
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
    assert os.path.exists(_native.library_path("fused_fm"))
    _native.build()  # already built: nvcc is not run again
    calls = (build_env / "bin" / "nvcc.calls").read_text().split()
    assert calls == ["called"]


def test_check_raises_on_cuda_error():
    _native.check(0, "fused_fm")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _native.check(9, "fused_fm")
