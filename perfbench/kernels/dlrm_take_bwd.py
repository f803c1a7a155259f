"""``dfm_take_bwd`` (``csrc/embedding.cu``) in a DLRM-DCNv2 step: one
launch a feature, the gradient of its bag's view summed per uid slot of
its plan in position order (the short runs' kernel, then
``take_bwd_long_kernel`` for runs above 256 positions). Feature f has
N_f = B * hotness[f] positions and as many uid slots U_f = N_f (the real
ones first, then the fill), D = K.

What the inputs need, each byte once: the float32 cotangent [N_f, D], the
position order [N_f] and the slot starts [U_f + 1] (int32) read, the
[U_f, D] float32 gradient written (the kernel writes every slot's row,
zero where no position falls); one add per position and column."""

MATCH = ("take_bwd",)


def need(s):
    b, d = s["batch"], s["dim"]
    out = []
    for h in s["hotness"]:
        n = u = b * h
        nbytes = 4 * d * n + 4 * n + 4 * (u + 1) + 4 * d * u
        out.append((n * d, nbytes, "f32_flops_per_s"))
    return out
