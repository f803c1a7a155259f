"""The kernel counts, worked by hand at one small shape."""

import pytest

from perfbench.core import device_trace, registry

FLAGS = {"model": "deepfm", "field_size": 3, "embedding_size": 4,
         "deep_layers": "5,2", "compute_dtype": "bfloat16"}
DEEPFM = registry.family("deepfm")
S = DEEPFM.step_shapes(FLAGS, 10, {"fm_w": (100,), "fm_v": (100, 4)})


def test_shapes():
    assert S["tower"] == [12, 5, 2]


def test_take_bwd():
    # N = 30 positions, U = 100 rows; D = 1 and D = 4, float32.
    got = registry.kernel("take_bwd").need(S)
    assert got == [(30, 4 * 30 + 4 * 30 + 4 * 101 + 4 * 100,
                    "f32_flops_per_s"),
                   (120, 4 * 120 + 4 * 30 + 4 * 101 + 4 * 400,
                    "f32_flops_per_s")]


def test_segments():
    assert registry.kernel("segments").need(S) == [
        (0, 8 * 30 + 4 * 30 + 4 * 101, "f32_flops_per_s")]


def test_fm():
    assert registry.kernel("fm_fwd").need(S) == [
        (10 * 3 * 14, 10 * 3 * 6 * 4 + 40, "f32_flops_per_s")]
    assert registry.kernel("fm_bwd").need(S) == [
        (10 * 3 * 10, 2 * 10 * 3 * 6 * 4 + 40, "f32_flops_per_s")]


def test_tower_gemm():
    got = registry.kernel("tower_gemm").need(S)
    # 12x5 and 5x2 layers, three products each, bf16 operands.
    l0 = (2 * 10 * 12 * 5, 2 * (10 * 12 + 12 * 5 + 10 * 5), "bf16_flops_per_s")
    l1 = (2 * 10 * 5 * 2, 2 * (10 * 5 + 5 * 2 + 10 * 2), "bf16_flops_per_s")
    assert got == [l0] * 3 + [l1] * 3


def test_mfu_flops_per_example():
    assert S["flops_per_example"] == 6 * (12 * 5 + 5 * 2 + 2)
    ctx = device_trace.Context(ops=[], spans=[], t0=0, t1=1, steps=1,
                               examples_per_s=1e9, cards=2, shapes=S,
                               peaks={"bf16_flops_per_s": 1e12},
                               kernel=registry.kernel)
    assert registry.metric("train_mfu_pct").read(ctx) == pytest.approx(
        100.0 * S["flops_per_example"] * 1e9 / 2e12)


@pytest.mark.parametrize("kernel", ["take_bwd", "segments", "fm_fwd",
                                    "fm_bwd", "tower_gemm"])
def test_roofline_is_least_time_over_kernel_time(kernel):
    """A window whose kernels took exactly the least time reads 100%."""
    peaks = registry.Registry().peaks()
    mod = registry.kernel(kernel)
    big = DEEPFM.step_shapes(dict(FLAGS, field_size=39, embedding_size=32,
                                  deep_layers="128,64,32"),
                             65536, {"fm_w": (117632,), "fm_v": (117632, 32)})
    ctx = device_trace.Context(ops=[], spans=[], t0=0, t1=1, steps=4,
                               examples_per_s=1.0, cards=1, shapes=big,
                               peaks=peaks, kernel=registry.kernel)
    least = ctx.least_seconds(kernel)
    if least == 0:
        pytest.skip("no launch at this shape")
    ctx.ops = [device_trace.DeviceOp(mod.MATCH[0] + "_x", "kernel", 0,
                                     int(round(least * 4 * 1e9)))]
    assert abs(ctx.roofline_pct(kernel) - 100.0) < 1e-3
    ctx.ops[0].dur_ns *= 2
    assert abs(ctx.roofline_pct(kernel) - 50.0) < 1e-3
