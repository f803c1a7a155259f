"""The take backward's long-run path (``csrc/embedding.cu``
``take_bwd_long_kernel``): runs of more than ``ek.LONG_RUN`` positions.

On the card (marked ``card``, skipped without one): each case is one
``dfm_take_bwd`` launch, bit-equal to the numpy ascending-p oracle
(``np.add.at``; for a bfloat16 cotangent, to the plain version on the
CPU, whose adds round to bfloat16 one position after another) and to its
second launch; empty slots read zero; the launch's count of long runs and
of their positions is the cases'. Run from the repository's root with
``python -m pytest --noconftest tests/test_torch_take_bwd_long_runs.py``.
"""

import json

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.obs import trace as trace_lib
from deepfm_tpu_torch.ops import embedding_kernels as ek

L = ek.LONG_RUN
F32, BF16 = torch.float32, torch.bfloat16

# name: (D, dtype, byte offset of g, N, slot counts, {table: {slot: run}}).
# The other positions of each table fall uniformly on its other slots (a
# few positions each), so only the listed runs can be long.
CASES = {
    "run_L-1": (32, F32, 0, 16_384, [8192], {0: {5: L - 1}}),
    "run_L": (32, F32, 0, 16_384, [8192], {0: {5: L}}),
    "run_L+1": (32, F32, 0, 16_384, [8192], {0: {5: L + 1}}),
    "run_131072": (32, F32, 0, 147_456, [8192], {0: {5: 131_072}}),
    "one_slot_all": (32, F32, 0, 50_000, [4], {0: {2: 50_000}}),
    "d1_run_131072": (1, F32, 0, 147_456, [8192], {0: {9: 131_072}}),
    "d1_run_L+1": (1, F32, 0, 16_384, [8192], {0: {9: L + 1, 10: L}}),
    "d3_scalar": (3, F32, 0, 16_384, [4096], {0: {1: L + 1, 7: 4000}}),
    "d2_float2_offset": (2, F32, 8, 16_384, [4096],
                         {0: {3: L + 1, 4: 5000}}),
    "d33_five_slices": (33, F32, 0, 16_384, [4096], {0: {9: 7000}}),
    "bf16_d32": (32, BF16, 0, 16_384, [4096], {0: {0: 6000, 11: L + 1}}),
    "bf16_d3": (3, BF16, 0, 16_384, [4096], {0: {2: 3000}}),
    "several_in_one_table": (32, F32, 0, 100_000, [8192],
                             {0: {0: 3000, 10: L + 1, 20: 60_000,
                                  33: 2048, 34: L}}),
    "three_of_eight_tables": (32, F32, 0, 20_000, [4096] * 8,
                              {1: {3: 5000}, 4: {0: L + 1, 100: 2000},
                               6: {4095: 9000}}),
    "three_of_eight_tables_d1": (1, F32, 0, 20_000, [4096] * 8,
                                 {1: {3: 5000}, 4: {0: L + 1, 100: 2000},
                                  6: {4095: 9000}}),
}


def _inv(rng, n: int, u: int, runs: dict) -> np.ndarray:
    inv = np.empty(n, np.int64)
    perm = rng.permutation(n)
    i = 0
    for slot, length in runs.items():
        inv[perm[i:i + length]] = slot
        i += length
    others = np.setdiff1d(np.arange(u), list(runs))
    inv[perm[i:]] = rng.choice(others, n - i)
    return inv


def _cotangent(rng, n: int, d: int, dtype, offset: int, dev):
    """[n, d] of ``dtype`` on the card whose data starts ``offset`` bytes
    past an allocation's start."""
    skip = offset // torch.tensor([], dtype=dtype).element_size()
    flat = torch.empty(skip + n * d, dtype=dtype, device=dev)
    g = flat[skip:].view(n, d)
    g.copy_(torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).to(dtype))
    return g


def _oracle(g: torch.Tensor, inv: np.ndarray, u: int) -> torch.Tensor:
    if g.dtype == torch.float32:
        out = np.zeros((u, g.shape[1]), np.float32)
        np.add.at(out, inv, g.cpu().numpy())
        return torch.from_numpy(out)
    return ek.reference_take_bwd(g.cpu(), torch.from_numpy(inv), u)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES))
def test_long_runs_bit_equal_to_the_oracle(card, name):
    d, dtype, offset, n, slots, runs = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    g = _cotangent(rng, n, d, dtype, offset, card)
    assert g.data_ptr() % 16 == offset % 16
    invs = [_inv(rng, n, u, runs.get(t, {})) for t, u in enumerate(slots)]
    segs = [ek.reference_position_segments(torch.from_numpy(v).to(card), u)
            for v, u in zip(invs, slots)]
    stats = torch.full((2,), -1, dtype=torch.int64, device=card)
    a = ek._launch_take_bwd_tables(g, segs, slots, stats)
    b = ek._launch_take_bwd_tables(g, segs, slots)
    torch.cuda.synchronize()
    longs = [r for t in runs.values() for r in t.values() if r > L]
    assert stats.tolist() == [len(longs), sum(longs)]
    for t, (v, u) in enumerate(zip(invs, slots)):
        want = _oracle(g, v, u)
        got = a[t].cpu()
        assert torch.equal(got.view(torch.int16 if dtype == BF16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == BF16
                                     else torch.int32)), (name, t)
        assert torch.equal(a[t], b[t]), (name, t)
        empty = np.bincount(v, minlength=u) == 0
        assert not got[torch.from_numpy(empty)].any(), (name, t)


@pytest.mark.card
def test_counts_reach_the_embed_bwd_span_and_the_totals(card, tmp_path):
    rng = np.random.default_rng(7)
    n, u, d = 40_000, 4096, 32
    runs = {2: L + 1, 8: 20_000}
    g = _cotangent(rng, n, d, F32, 0, card)
    inv = torch.from_numpy(_inv(rng, n, u, runs)).to(card)
    seg = ek.reference_position_segments(inv, u)
    totals = ek.take_bwd_long_runs, ek.take_bwd_long_positions
    trace_lib.configure("full", export_env=False)
    try:
        with trace_lib.span("embed.bwd", device=card):
            ek._launch_take_bwd_tables(g, [seg], [u])
            ek._launch_take_bwd_tables(g, [seg], [u])
        path = trace_lib.export(str(tmp_path / "trace.json"))
    finally:
        trace_lib.reset()
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("name") == "embed.bwd"]
    assert len(spans) == 1
    want = (2 * len(runs), 2 * sum(runs.values()))
    assert (spans[0]["args"]["long_runs"],
            spans[0]["args"]["long_positions"]) == want
    assert (ek.take_bwd_long_runs - totals[0],
            ek.take_bwd_long_positions - totals[1]) == want
