"""``dfm_segments`` (``csrc/embedding.cu``): the position segments of the
batch's ids, built once a step for both dense lookups (a counting sort).

Each byte once: the N = B * F int64 ids read, the int32 position order
[N] and the row starts [U + 1] written. A few integer operations a
position, not counted against a floating-point peak."""

MATCH = ("segments_kernel",)


def need(s):
    n, u = s["batch"] * s["fields"], s["rows"]
    return [(0, 8 * n + 4 * n + 4 * (u + 1), "f32_flops_per_s")]
