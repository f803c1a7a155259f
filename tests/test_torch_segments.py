"""The position segments that order the take backward's sums
(``embedding_kernels.position_segments``/``_tables``, whose CUDA kernel is
``dfm_segments``) and the dense lookups that share one segments build per
batch (``SharedSegments``), against numpy and the JAX package, on the CPU.

On the CPU the wrappers take their plain versions
(``reference_position_segments``/``_tables``: a stable sort and a
searchsorted) and ``index_add_`` for the sums, which adds one position
after another. Segments are integer work and the sums repeat the JAX
package's float32 adds in its order, so every comparison here is
bit-equal. The Pallas kernels run through the Pallas interpreter (the
``pallas`` marker), as ``tests/test_pallas_embedding.py`` runs them. The
kernel itself runs only on the card: ``chip_smoke.py`` holds it against
the plain version there, on the inputs below and the main path's shapes.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.models import common as jax_common
from deepfm_tpu.ops import pallas_embedding as pemb
from deepfm_tpu_torch import _native
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.models import common, get_model
from deepfm_tpu_torch.ops import embedding as emb
from deepfm_tpu_torch.ops import embedding_kernels as ek

torch.set_num_threads(1)

N = 600


def _oracle(inv: np.ndarray, u: int, keep):
    """numpy: the stable argsort of the keys (inv, or u where left out or
    outside [0, u)) and the searchsorted starts of slots 0..u."""
    ok = (inv >= 0) & (inv < u)
    if keep is not None:
        ok &= keep
    key = np.where(ok, inv, u)
    order = np.argsort(key, kind="stable")
    return order, np.searchsorted(key[order], np.arange(u + 1), side="left")


def _case(kind: str, t: int, rng):
    """(inv [t, n], slot counts) of one input family."""
    if kind == "uniform":
        return rng.integers(0, N, (t, N)).astype(np.int32), [N] * t
    if kind == "zipf":  # a few hot slots hold most positions
        u = 5000
        return np.minimum(rng.zipf(1.1, (t, N)) - 1, u - 1), [u] * t
    if kind == "one_slot":
        return np.full((t, N), 3, np.int32), [7] * t
    if kind == "n1":
        return np.zeros((t, 1), np.int32), [11] * t
    if kind == "u_much_larger":
        return rng.integers(0, 10 ** 6, (t, 40)), [10 ** 6] * t
    if kind == "u1":
        return np.zeros((t, N), np.int32), [1] * t
    if kind == "unequal_slots":
        return (rng.integers(-3, 70, (t, N)).astype(np.int32),
                [60 + 3 * i for i in range(t)])
    raise ValueError(kind)


KINDS = ["uniform", "zipf", "one_slot", "n1", "u_much_larger", "u1",
         "unequal_slots"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_segments_match_numpy_stable_argsort(kind, masked):
    """One table: order and starts equal numpy's stable argsort and its
    searchsorted, with and without ``keep``."""
    rng = np.random.default_rng(KINDS.index(kind) * 2 + masked)
    inv, slots = _case(kind, 1, rng)
    keep = rng.random(inv.shape) < 0.3 if masked else None
    order, starts = ek.position_segments(
        torch.from_numpy(inv[0]), slots[0],
        None if keep is None else torch.from_numpy(keep[0]))
    want_o, want_s = _oracle(inv[0], slots[0],
                             None if keep is None else keep[0])
    assert order.dtype == starts.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want_o)
    np.testing.assert_array_equal(starts.numpy(), want_s)


@pytest.mark.parametrize("t", range(1, ek.MAX_TABLES + 1))
@pytest.mark.parametrize("kind", ["uniform", "zipf", "unequal_slots"])
def test_plain_segments_tables_match_numpy(kind, t):
    """T = 1..8 tables at once (one slot count, or one per table), half of
    them with ``keep``: each table's pair equals the oracle's."""
    rng = np.random.default_rng(100 * t + len(kind))
    inv, slots = _case(kind, t, rng)
    keep = rng.random(inv.shape) < 0.5 if t % 2 else None
    got = ek.position_segments_tables(
        torch.from_numpy(inv), slots if kind == "unequal_slots" else slots[0],
        None if keep is None else torch.from_numpy(keep))
    assert len(got) == t
    for i, (order, starts) in enumerate(got):
        want_o, want_s = _oracle(inv[i], slots[i],
                                 None if keep is None else keep[i])
        np.testing.assert_array_equal(order.numpy(), want_o)
        np.testing.assert_array_equal(starts.numpy(), want_s)


def test_out_of_range_inv_joins_the_left_out_run():
    """An inv outside [0, U) is left out like a masked position: the runs
    of the slots hold only in-range kept positions, the rest follow in
    ascending position."""
    inv = torch.tensor([2, -1, 0, 9, 2, 4, 1], dtype=torch.int32)
    keep = torch.tensor([True, True, True, True, False, True, True])
    order, starts = ek.position_segments(inv, 4, keep)
    assert starts.tolist() == [0, 1, 2, 3, 3]
    assert order.tolist() == [2, 6, 0, 1, 3, 4, 5]


def _segment_sum_in_order(g: np.ndarray, order, starts, u: int):
    """What the take backward kernel computes from the segments: each
    slot's cotangents in run order from 0.0, one float32 add at a time."""
    out = np.zeros((u,) + g.shape[1:], np.float32)
    for s in range(u):
        for p in order[starts[s]:starts[s + 1]]:
            out[s] = out[s] + g[p]
    return out


@pytest.mark.pallas
@pytest.mark.parametrize("kind", ["uniform", "zipf", "one_slot"])
@pytest.mark.parametrize("d", [1, 8])
def test_segment_sum_matches_pallas_take_bwd(kind, d):
    """``segment_sum``'s plain leg, and the sum the kernel takes over the
    segments, equal the TPU kernel's loop (``_take_pallas_bwd`` in the
    Pallas interpreter) bit for bit."""
    rng = np.random.default_rng(7 + d)
    inv, slots = _case(kind, 1, rng)
    inv, u = inv[0].astype(np.int32), slots[0]
    n = 200  # the interpreter walks the loop one position at a time
    inv = inv[:n]
    g = (rng.standard_normal((n, d)) * 10.0 ** rng.integers(-3, 4, (n, 1))
         ).astype(np.float32)
    want = np.asarray(pemb._take_pallas_bwd(
        jnp.asarray(g), jnp.asarray(inv).reshape(1, -1), u, True))
    got = ek.segment_sum(torch.from_numpy(g), torch.from_numpy(inv), u)
    np.testing.assert_array_equal(got.numpy(), want)
    order, starts = ek.position_segments(torch.from_numpy(inv), u)
    np.testing.assert_array_equal(
        _segment_sum_in_order(g, order.numpy(), starts.numpy(), u), want)


# ---------------------------------------------------------------------------
# Input checks of the kernel's wrapper (they run before any launch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["float_inv", "keep_dtype", "keep_shape",
                                  "negative_slots", "int32_slots",
                                  "positions"])
def test_segments_launch_checks_its_inputs(case):
    inv = torch.zeros((2, 5), dtype=torch.int32)
    keep, slots, err = None, [4, 4], ValueError
    if case == "float_inv":
        inv, err = inv.float(), TypeError
    elif case == "keep_dtype":
        keep = torch.zeros((2, 5), dtype=torch.uint8)
    elif case == "keep_shape":
        keep = torch.zeros((2, 4), dtype=torch.bool)
    elif case == "negative_slots":
        slots = [4, -1]
    elif case == "int32_slots":
        slots = [4, 2 ** 31 - 1]
    else:  # T * N positions past int32, without allocating them
        inv = torch.zeros((1, 1), dtype=torch.int32).expand(8, 2 ** 28)
        slots = [4] * 8
    with pytest.raises(err):
        ek._launch_segments(inv, slots, keep)


def test_segments_slot_counts_match_tables():
    with pytest.raises(ValueError, match="slot counts"):
        ek.position_segments_tables(torch.zeros((3, 4), dtype=torch.int32),
                                    [4, 4])


def test_segments_binder_is_declared():
    """The C signatures of dfm_segments (11 arguments, int return) and
    dfm_segments_scratch (int64 return) are declared on the embedding
    library."""
    class FakeFn:
        argtypes = restype = None

    class FakeLib:
        pass

    lib = FakeLib()
    for name in ("dfm_plan_build", "dfm_take_fwd", "dfm_take_bwd",
                 "dfm_install", "dfm_segments", "dfm_segments_scratch"):
        setattr(lib, name, FakeFn())
    _native._BINDERS["embedding"](lib)
    seg = lib.dfm_segments
    assert len(seg.argtypes) == 11 and seg.restype is ctypes.c_int
    assert seg.argtypes[1] is ctypes.c_int
    assert seg.argtypes[5] is ctypes.c_int64
    scr = lib.dfm_segments_scratch
    assert scr.argtypes == [ctypes.c_int, ctypes.c_int64]
    assert scr.restype is ctypes.c_int64


# ---------------------------------------------------------------------------
# One segments build per batch for the dense lookups
# ---------------------------------------------------------------------------

def test_shared_segments_build_once(monkeypatch):
    """Every table's segments come from one ``position_segments_tables``
    call, made at the first request; later requests reuse it."""
    calls = []
    real = ek.position_segments_tables

    def counting(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(ek, "position_segments_tables", counting)
    ids = torch.tensor([[3, 0, 3, 1], [2, 2, 0, 5]])
    shared = ek.SharedSegments(ids, [4, 6])
    assert calls == []
    first = shared.segments(1)
    again = shared.segments(0), shared.segments(1)
    assert len(calls) == 1 and again[1] is first
    want = ek.reference_position_segments(ids[0], 4)
    assert torch.equal(again[0][0], want[0])
    assert torch.equal(again[0][1], want[1])


def test_cpu_backward_builds_no_segments(monkeypatch):
    """On the CPU the gradient is ``index_add_``: the shared segments are
    never built and no kernel launches."""
    monkeypatch.setattr(ek, "position_segments_tables", lambda *a, **k: (
        pytest.fail("segments built on the CPU")))
    before = ek.segments_launches, ek.take_bwd_launches
    table = torch.randn(6, 3, requires_grad=True)
    shared = ek.SharedSegments(torch.tensor([[5, 0, 5, 2]]), [6])
    out = shared.rows(table)
    torch.autograd.grad(out.sum(), table)
    assert (ek.segments_launches, ek.take_bwd_launches) == before


def test_shared_rows_refuse_another_height():
    shared = ek.SharedSegments(torch.tensor([[1, 0]]), [5])
    with pytest.raises(ValueError, match="rows"):
        shared.rows(torch.zeros(4, 2))


def _dense_cfg(**kw):
    return dict(feature_size=50, field_size=5, embedding_size=4,
                deep_layers="8", dropout="1.0,1.0", batch_norm=False,
                compute_dtype="float32", **kw)


@pytest.mark.parametrize("hashed", [False, True])
def test_shared_dense_gradient_equals_per_name(hashed, monkeypatch):
    """The model's embedding gradients with one shared index per batch
    (fm_w and fm_v, every hashed table) equal those of a lookup per name,
    each building its own index, bit for bit; the forward too."""
    kw = dict(embedding_buckets="37,53,41", embedding_assign="hash") \
        if hashed else {}
    cfg = Config(**_dense_cfg(**kw))
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 50, (16, 5)).astype(np.int32))
    vals = torch.from_numpy(rng.random((16, 5), dtype=np.float32))
    params = [p for n, p in model.named_parameters() if n.startswith("fm_")]
    shared_out = model(ids, vals)
    shared = torch.autograd.grad(shared_out.sum(), params)

    lookup = type(model)._emb_lookup
    monkeypatch.setattr(  # each name builds its own index
        type(model), "_emb_lookup",
        lambda self, name, feat_ids, rows, plan, index=None, shard=None:
        lookup(self, name, feat_ids, rows, plan, shard=shard))
    own_out = model(ids, vals)
    own = torch.autograd.grad(own_out.sum(), params)
    np.testing.assert_array_equal(shared_out.detach().numpy(),
                                  own_out.detach().numpy())
    for a, b in zip(shared, own):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_dense_index_shares_one_build_for_every_hashed_table():
    cfg = Config(**_dense_cfg(embedding_buckets="37,53,41",
                              embedding_assign="hash"))
    schema = common.EmbeddingSchema(cfg)
    entry = {f"t{i}": torch.zeros(b, 2) for i, b in enumerate((37, 53, 41))}
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 50, (4, 5)).astype(np.int32))
    index = schema.dense_index(ids, entry)
    assert isinstance(index, ek.SharedSegments)
    assert tuple(index.ids.shape) == (3, 20) and index.num_slots == [37, 53,
                                                                     41]
    for i, b in enumerate((37, 53, 41)):
        np.testing.assert_array_equal(
            index.ids[i].numpy(),
            emb.hash_bucket(ids, b, salt=i + 1).reshape(-1).long().numpy())


def test_hashed_dense_gradient_matches_jax_lookup_vjp():
    """The dense hashed lookup's gradient per table, through the shared
    index, equals the VJP of the JAX schema's lookup bit for bit."""
    kw = dict(feature_size=10 ** 6, field_size=5, embedding_size=4,
              embedding_buckets="97,7,1,300", embedding_assign="hash")
    js = jax_common.EmbeddingSchema(JaxConfig(**kw))
    ts = common.EmbeddingSchema(Config(**kw))
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 10 ** 6, (24, 5)).astype(np.int32)
    tables = {f"t{i}": rng.standard_normal((b, 4)).astype(np.float32)
              for i, b in enumerate((97, 7, 1, 300))}
    g = rng.standard_normal((24, 5, 4)).astype(np.float32)
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in tables.items()}
    out = ts.lookup(leaves, torch.from_numpy(ids))
    got = torch.autograd.grad(out, list(leaves.values()), torch.from_numpy(g))
    jout, vjp = jax.vjp(lambda e: js.lookup(e, jnp.asarray(ids)),
                        {k: jnp.asarray(v) for k, v in tables.items()})
    want, = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    for k, gr in zip(leaves, got):
        np.testing.assert_array_equal(gr.numpy(), np.asarray(want[k]))
