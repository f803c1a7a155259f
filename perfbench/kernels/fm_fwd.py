"""The fused FM forward (``csrc/fused_fm.cu``), once a step on DeepFM:
w and vals [B, F] and xv [B, F, K], all float32, read once; the [B]
float32 output written; ~3 operations per xv element and 2 per w."""

MATCH = ("fm_fwd",)


def need(s):
    b, f, k = s["batch"], s["fields"], s["dim"]
    return [(b * f * (3 * k + 2), b * f * (k + 2) * 4 + 4 * b,
             "f32_flops_per_s")]
