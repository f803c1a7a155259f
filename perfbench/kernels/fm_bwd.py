"""The fused FM backward (``csrc/fused_fm.cu``), once a step on DeepFM:
the [B] float32 cotangent and w, vals, xv read once, dw, dvals and dxv
(float32, their primals' shapes) written once; ~2 operations per output
element."""

MATCH = ("fm_bwd",)


def need(s):
    b, f, k = s["batch"], s["fields"], s["dim"]
    return [(b * f * (2 * k + 2), 2 * b * f * (k + 2) * 4 + 4 * b,
             "f32_flops_per_s")]
