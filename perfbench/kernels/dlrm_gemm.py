"""The matrix products of a DLRM-DCNv2 training step, in the compute dtype
(bfloat16): the bottom MLP's and the top MLP's hidden layers, forward
(X W) and backward (dH W^T and X^T dH; the bottom's first layer reads
the data, so it has no input gradient), and the cross network's two
low-rank products a layer (x v, then (x v) u), each with its two
backward products. The top MLP's [d, 1] head is a row-wise dot, no
product.

Each product: 2 m n k operations; its two operands read once and its
result written once, in their dtypes."""

MATCH = ("gemm", "nvjet", "xmma", "cutlass", "splitk", "splitK")


def _product(m, k, n, cb):
    return (2 * m * k * n, cb * (m * k + k * n + m * n), "bf16_flops_per_s")


def need(s):
    b, cb = s["batch"], s["compute_bytes"]
    out = []
    for i, (d_in, d_out) in enumerate(zip(s["bottom"][:-1], s["bottom"][1:])):
        out += [_product(b, d_in, d_out, cb)] * (2 if i == 0 else 3)
    d, r = s["cross_dim"], s["cross_rank"]
    out += [_product(b, d, r, cb), _product(b, r, d, cb)] * 3 \
        * s["cross_layers"]
    for d_in, d_out in zip(s["top"][:-1], s["top"][1:]):
        out += [_product(b, d_in, d_out, cb)] * 3
    return out
