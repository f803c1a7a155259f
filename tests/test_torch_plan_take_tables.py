"""The multi-table plan build and the fused take forward
(``embedding_kernels.plan_build_tables`` and ``TakeRowsSum``) against the
JAX package's per-table plans and lookups, on the CPU.

On the CPU both wrappers take their plain versions: ``make_plan_counting``
per table, and the composition ``rows[inv] * mask`` summed in table order
with ``reference_take_bwd`` per table as its backward. Plans are integer
work and the takes repeat the JAX package's float32 operations in its
order, so every comparison here is bit-equal. The Pallas kernels run
through the Pallas interpreter (the ``pallas`` marker), as
``tests/test_pallas_embedding.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.models import common as jax_common
from deepfm_tpu.ops import embedding as jax_emb
from deepfm_tpu.ops import pallas_embedding as pemb
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.models import common
from deepfm_tpu_torch.ops import embedding as emb
from deepfm_tpu_torch.ops import embedding_kernels as ek

torch.set_num_threads(1)

B, F = 24, 5
UNEQUAL = "97,7,1,300"   # four hashed tables of unequal rows


def _schemas(buckets, assign="hash"):
    kw = dict(feature_size=10 ** 6, field_size=F, embedding_size=4,
              embedding_update="sparse", embedding_buckets=buckets,
              embedding_assign=assign)
    return (jax_common.EmbeddingSchema(JaxConfig(**kw)),
            common.EmbeddingSchema(Config(**kw)))


def _feat_ids(seed):
    return np.random.default_rng(seed).integers(0, 10 ** 6, (B, F)).astype(
        np.int32)


def _assert_entry_equal(got, want):
    """uids, inv and touched bit-equal, rank where touched, mask equal."""
    for f in ("uids", "inv", "touched"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    touched = np.asarray(want.touched)
    np.testing.assert_array_equal(got.rank.numpy()[touched],
                                  np.asarray(want.rank)[touched])
    assert got.num_rows == want.num_rows
    if want.mask is None:
        assert got.mask is None
    else:
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def _jax_per_table_ids(js, jids):
    """Each hashed table's ids (masked positions at its fill id), the JAX
    ``sparse_plan``'s own construction."""
    table_of = js._table_of(jids)
    ids, masks = [], []
    for i, b in enumerate(js.buckets):
        sel = table_of == i
        bucket = jax_emb.hash_bucket(jids, b, salt=i + 1)
        ids.append(np.array(jnp.where(sel, bucket, jnp.int32(b))))
        masks.append(np.array(sel.astype(jnp.float32)))
    return ids, masks


# ---------------------------------------------------------------------------
# Plan build over several tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("assign", ["hash", "field"])
def test_plan_tables_match_jax_sparse_plan(seed, assign):
    """One call for the four hashed tables of unequal rows, from the JAX
    side's per-table ids, gives each table's JAX ``sparse_plan`` entry bit
    for bit; the port's ``sparse_plan`` (which calls it once) does too."""
    js, ts = _schemas(UNEQUAL, assign)
    ids = _feat_ids(seed)
    jplan = js.sparse_plan(jnp.asarray(ids))
    per_ids, per_masks = _jax_per_table_ids(js, jnp.asarray(ids))
    got = ek.plan_build_tables([torch.from_numpy(x) for x in per_ids],
                               ts.buckets,
                               [torch.from_numpy(m) for m in per_masks])
    assert len(got) == 4
    for entry, key in zip(got, jplan):
        _assert_entry_equal(entry, jplan[key])
    tplan = ts.sparse_plan(torch.from_numpy(ids))
    assert list(tplan) == list(jplan)
    for key in jplan:
        _assert_entry_equal(tplan[key], jplan[key])


def _fill_ids(n, rows, seed, fill):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, rows, n).astype(np.int32)
    ids[rng.random(n) < fill] = rows
    return ids


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("fill", [0.0, 0.5, 0.75, 1.0])
def test_plan_tables_fill_shares_and_unequal_rows(seed, fill):
    """Tables of 64, 7, 1 and 300 rows (fewer rows than ids, one row, more
    rows than ids) at a share ``fill`` of fill positions: each entry equals
    the JAX counting plan and the numpy oracle, given as a list of id
    tensors or as one stacked ``[T, ...]`` tensor."""
    rows = [64, 7, 1, 300]
    ids = [_fill_ids(120, r, seed + i, fill).reshape(12, 10)
           for i, r in enumerate(rows)]
    listed = ek.plan_build_tables([torch.from_numpy(x) for x in ids], rows)
    stacked = ek.plan_build_tables(torch.from_numpy(np.stack(ids)), rows)
    for x, r, a, b in zip(ids, rows, listed, stacked):
        want = jax_emb.make_plan_counting(jnp.asarray(x), r)
        _assert_entry_equal(a, want)
        _assert_entry_equal(b, want)
        uids, inv, touched, _ = pemb.reference_plan_numpy(x, r)
        np.testing.assert_array_equal(a.uids.numpy(), uids)
        np.testing.assert_array_equal(a.inv.numpy(), inv)
        np.testing.assert_array_equal(a.touched.numpy(), touched)
        assert a.inv.shape == (12, 10) and a.rank.shape == (r,)


@pytest.mark.pallas
@pytest.mark.parametrize("rows,seed,fill", [(40, 5, 0.75), (16, 6, 0.0),
                                            (300, 7, 0.3)])
def test_plan_tables_single_table_matches_pallas_kernel(rows, seed, fill):
    ids = _fill_ids(48, rows, seed, fill).reshape(8, 6)
    want = pemb.plan_build_pallas(jnp.asarray(ids), rows, interpret=True)
    got, = ek.plan_build_tables([torch.from_numpy(ids)], [rows])
    _assert_entry_equal(got, want)


def test_sparse_plan_beyond_one_launch_matches_jax():
    """Nine hashed tables: the kernel leg builds them in launches of up to
    eight; every entry still equals the JAX plan, and the fused view (taken
    per table past eight) equals the JAX lookup."""
    buckets = "11,13,17,19,23,29,31,37,41"
    js, ts = _schemas(buckets)
    ids = _feat_ids(9)
    jplan, tplan = js.sparse_plan(jnp.asarray(ids)), ts.sparse_plan(
        torch.from_numpy(ids))
    for key in jplan:
        _assert_entry_equal(tplan[key], jplan[key])
    rng = np.random.default_rng(9)
    rows = {k: rng.standard_normal((B * F, 3)).astype(np.float32)
            for k in jplan}
    want = js.lookup_rows({k: jnp.asarray(v) for k, v in rows.items()}, jplan)
    got = ts.lookup_rows({k: torch.from_numpy(v) for k, v in rows.items()},
                         tplan)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Fused take forward and its VJP
# ---------------------------------------------------------------------------

def _gathered(plan, d, seed):
    """Per table: rows [N, d] (or [N] at d = 0, the 1-D fm_w) with the fill
    slots zero, as ``gather_rows`` hands them over."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, e in plan.items():
        shape = (B * F, d) if d else (B * F,)
        r = rng.standard_normal(shape).astype(np.float32)
        r[np.asarray(e.uids) >= e.num_rows] = 0.0
        out[k] = r
    return out


@pytest.mark.parametrize("d", [0, 1, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_take_rows_sum_matches_jax_lookup_rows_and_vjp(d, seed):
    """The fused view of four hashed tables and its gradient per table
    equal the JAX ``EmbeddingSchema.lookup_rows`` and its VJP bit for bit
    (d = 0 is the 1-D fm_w table)."""
    js, ts = _schemas(UNEQUAL)
    ids = _feat_ids(seed)
    jplan = js.sparse_plan(jnp.asarray(ids))
    tplan = ts.sparse_plan(torch.from_numpy(ids))
    rows = _gathered(jplan, d, seed)
    g = np.random.default_rng(seed + 7).standard_normal(
        (B, F) + ((d,) if d else ())).astype(np.float32)
    want, vjp = jax.vjp(lambda r: js.lookup_rows(r, jplan),
                        {k: jnp.asarray(v) for k, v in rows.items()})
    want_d, = vjp(jnp.asarray(g))
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in rows.items()}
    keys = list(tplan)
    got = ek.take_rows_sum([leaves[k] for k in keys],
                           [tplan[k].inv for k in keys],
                           [tplan[k].mask for k in keys])
    grads = torch.autograd.grad(got, [leaves[k] for k in keys],
                                torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    for k, gr in zip(keys, grads):
        assert gr.shape == leaves[k].shape
        np.testing.assert_array_equal(gr.numpy(), np.asarray(want_d[k]))


def _composition(rows, plan):
    """The torch composition the fused take replaces: per table ``rows[inv]``
    times its mask, summed in table order, under autograd."""
    out = None
    for k, e in plan.items():
        part = ek.reference_take(rows[k], e.inv)
        part = part * emb.trailing_dims(e.mask, part.dim())
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("d", [0, 1, 8])
def test_take_rows_sum_equals_torch_composition(d):
    """Forward and per-table gradients ``torch.equal`` to the composition,
    through ``EmbeddingSchema.lookup_rows`` on the kernel leg (one fused
    take) and the call itself."""
    _, ts = _schemas(UNEQUAL)
    plan = ts.sparse_plan(torch.from_numpy(_feat_ids(5)))
    rows = {k: torch.from_numpy(v) for k, v in _gathered(plan, d, 5).items()}
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, F) + ((d,) if d else ())).astype(np.float32))
    a = {k: v.clone().requires_grad_() for k, v in rows.items()}
    b = {k: v.clone().requires_grad_() for k, v in rows.items()}
    want = _composition(a, plan)
    got = ts.lookup_rows(b, plan)
    assert torch.equal(got, want)
    for x, y in zip(torch.autograd.grad(want, list(a.values()), g),
                    torch.autograd.grad(got, list(b.values()), g)):
        assert torch.equal(x, y)


def test_take_rows_sum_without_masks_is_a_take():
    """One table, no mask: rows[inv], and the gradient the position-order
    segment-sum; several tables without masks sum the takes."""
    rng = np.random.default_rng(2)
    r = [torch.from_numpy(rng.standard_normal((9, 3)).astype(np.float32))
         for _ in range(2)]
    inv = [torch.from_numpy(rng.integers(0, 9, 14).astype(np.int32))
           for _ in range(2)]
    leaf = r[0].clone().requires_grad_()
    out = ek.take_rows_sum([leaf], inv[:1])
    assert torch.equal(out, r[0][inv[0].long()])
    g = torch.ones(14, 3)
    d_rows, = torch.autograd.grad(out, leaf, g)
    assert torch.equal(d_rows, ek.reference_take_bwd(g, inv[0], 9))
    both = ek.take_rows_sum(r, inv)
    assert torch.equal(both, r[0][inv[0].long()] + r[1][inv[1].long()])


def test_cpu_plan_and_take_tables_launch_no_kernel():
    counts = (ek.plan_launches, ek.take_fwd_launches, ek.take_bwd_launches)
    _, ts = _schemas(UNEQUAL)
    plan = ts.sparse_plan(torch.from_numpy(_feat_ids(1)))
    rows = {k: torch.from_numpy(v).requires_grad_()
            for k, v in _gathered(plan, 2, 1).items()}
    out = ts.lookup_rows(rows, plan)
    torch.autograd.grad(out.sum(), list(rows.values()))
    assert (ek.plan_launches, ek.take_fwd_launches,
            ek.take_bwd_launches) == counts


# ---------------------------------------------------------------------------
# Wrapper input checks
# ---------------------------------------------------------------------------

def _take_args(t=2, n=6, u=5, d=3):
    rows = [torch.zeros(u, d) for _ in range(t)]
    inv = [torch.zeros(n, dtype=torch.int32) for _ in range(t)]
    masks = [torch.ones(n) for _ in range(t)]
    return rows, inv, masks


@pytest.mark.parametrize("case", [
    "tables", "no_tables", "n", "dtype", "rows", "masks"])
def test_plan_build_tables_checks_its_inputs(case):
    ids = [torch.zeros(6, dtype=torch.int32) for _ in range(3)]
    rows, masks = [4, 4, 4], None
    err = ValueError
    if case == "tables":
        ids, rows = ids * 3, rows * 3
    elif case == "no_tables":
        ids, rows = [], []
    elif case == "n":
        ids[1] = torch.zeros(7, dtype=torch.int32)
    elif case == "dtype":
        ids[2], err = torch.zeros(6), TypeError
    elif case == "rows":
        rows[0] = 0
    else:
        masks = [None]
    with pytest.raises(err):
        ek.plan_build_tables(ids, rows, masks)


@pytest.mark.parametrize("case", [
    "tables", "n", "mask_n", "rows_dtype", "inv_dtype", "mask_dtype",
    "bf16_masked", "rows_layout", "mask_layout", "width"])
def test_take_rows_sum_checks_its_inputs(case):
    rows, inv, masks = _take_args()
    err = ValueError
    if case == "tables":
        rows, inv, masks = _take_args(t=ek.MAX_TABLES + 1)
    elif case == "n":
        inv[1] = torch.zeros(7, dtype=torch.int32)
    elif case == "mask_n":
        masks[0] = torch.ones(7)
    elif case == "rows_dtype":
        rows, err = [r.double() for r in rows], TypeError
    elif case == "inv_dtype":
        inv, err = [v.long() for v in inv], TypeError
    elif case == "mask_dtype":
        masks[1], err = masks[1].double(), TypeError
    elif case == "bf16_masked":
        rows, err = [r.bfloat16() for r in rows], TypeError
    elif case == "rows_layout":
        rows[0] = torch.zeros(3, 5).t()
    elif case == "mask_layout":
        masks[0] = torch.ones(12)[::2]
    else:
        rows[1] = torch.zeros(5, 4)
    with pytest.raises(err):
        ek.take_rows_sum(rows, inv, masks)
