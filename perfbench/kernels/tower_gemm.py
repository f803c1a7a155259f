"""The matrix products of a training step: the tower's hidden layers in
the compute dtype (bfloat16), forward (X W), and backward (dH W^T and
X^T dH; the first layer's input gradient too, since it flows to the
embeddings). The [d, 1] output head is a row-wise dot, no product.

Each product: 2 m n k operations; its two operands read once and its
result written once, in their dtypes."""

MATCH = ("gemm", "nvjet", "xmma", "cutlass", "splitk", "splitK")


def need(s):
    b, cb = s["batch"], s["compute_bytes"]
    out = []
    dims = s["tower"]
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        flops = 2 * b * d_in * d_out
        io = cb * (b * d_in + d_in * d_out + b * d_out)
        out += [(flops, io, "bf16_flops_per_s")] * 3
    return out
