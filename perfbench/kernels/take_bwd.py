"""``dfm_take_bwd`` (``csrc/embedding.cu``): the dense lookups' gradient,
summed per table row in position order. One launch per embedding name a
step: ``fm_w`` (D = 1) and ``fm_v`` (D = K), over the N = B * F positions
of the batch and every row of the table.

What the inputs need, each byte once: the float32 cotangent [N, D], the
position order [N] and the row starts [U + 1] (int32) read, the whole
[U, D] float32 gradient written (the kernel writes every row, zero where
no position falls); one add per position and column."""

MATCH = ("take_bwd",)


def need(s):
    n, u = s["batch"] * s["fields"], s["rows"]
    out = []
    for d in (1, s["dim"]):
        nbytes = 4 * d * n + 4 * n + 4 * (u + 1) + 4 * d * u
        out.append((n * d, nbytes, "f32_flops_per_s"))
    return out
