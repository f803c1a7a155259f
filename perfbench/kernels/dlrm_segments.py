"""``dfm_segments`` (``csrc/embedding.cu``) in a DLRM-DCNv2 step: each
feature's position segments, built with its plan (``embed.plan``), one
launch for up to eight features of equal hotness. Feature f has N_f = B *
hotness[f] positions and as many uid slots U_f = N_f.

Each byte once: the int32 inv [N_f] read, the int32 position order [N_f]
and the slot starts [U_f + 1] written. A few integer operations a
position, not counted against a floating-point peak."""

MATCH = ("segments_kernel",)


def need(s):
    out = []
    for h in s["hotness"]:
        n = u = s["batch"] * h
        out.append((0, 4 * n + 4 * n + 4 * (u + 1), "f32_flops_per_s"))
    return out
