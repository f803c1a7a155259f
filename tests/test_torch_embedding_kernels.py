"""The port's sparse-embedding ops and kernel wrappers
(``deepfm_tpu_torch.ops.embedding`` and ``.embedding_kernels``) against the
JAX package's, on the CPU.

On the CPU every kernel wrapper takes its plain version: the counting plan
build for the plan kernel, ``rows[inv]`` and the position-order
segment-sum for the take pair. The JAX Pallas kernels run through the
Pallas interpreter (the ``pallas`` marker, as ``tests/test_pallas_embedding.py``
runs them). Plans, hashes and takes are integer work or exact copies, and
the segment-sum adds the same float32 values in the same order, so every
comparison here is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.ops import embedding as jax_emb
from deepfm_tpu.ops import pallas_embedding as pemb
from deepfm_tpu_torch.ops import embedding as emb
from deepfm_tpu_torch.ops import embedding_kernels as ek

torch.set_num_threads(1)

PLAN_CASES = [((8, 3), 32, 0, 0.0), ((16, 5), 64, 1, 0.3),
              ((4, 4), 16, 2, 0.0), ((12, 4), 40, 3, 0.75),
              ((1,), 5, 4, 0.0), ((30,), 8, 5, 0.0)]


def _ids(shape, rows, seed, fill):
    """Ids in [0, rows) with a share ``fill`` of positions at the fill id
    ``rows`` (masked positions of a hashed table)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, rows, shape).astype(np.int32)
    ids[rng.random(shape) < fill] = rows
    return ids


def _plan_np(p):
    return tuple(None if x is None else np.asarray(x)
                 for x in (p.uids, p.inv, p.touched, p.rank))


def _assert_plan_equal(got, want):
    gu, gi, gt, gr = _plan_np(got)
    wu, wi, wt, wr = want
    np.testing.assert_array_equal(gu, wu)
    np.testing.assert_array_equal(gi, wi)
    if wt is not None and gt is not None:
        np.testing.assert_array_equal(gt, wt)
        # rank is defined under touched only.
        np.testing.assert_array_equal(gr[wt], wr[wt])


# ---------------------------------------------------------------------------
# Plan build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,rows,seed,fill", PLAN_CASES)
@pytest.mark.parametrize("mode", ["auto", "xla", "off"])
def test_plan_legs_match_jax_legs_and_oracle(shape, rows, seed, fill, mode):
    """Every port leg gives uids/inv bit-equal to the JAX sort and
    counting legs and to the numpy oracle, fill ids included; the counting
    legs' touched and rank (under touched) equal the JAX counting leg's."""
    ids = _ids(shape, rows, seed, fill)
    got = ek.plan_build(torch.from_numpy(ids), rows, mode=mode)
    assert got.uids.dtype == got.inv.dtype == torch.int32
    assert tuple(got.inv.shape) == shape and got.uids.shape == (ids.size,)
    _assert_plan_equal(got, _plan_np(jax_emb.make_plan(jnp.asarray(ids),
                                                       rows)))
    _assert_plan_equal(got, _plan_np(jax_emb.make_plan_counting(
        jnp.asarray(ids), rows)))
    _assert_plan_equal(got, pemb.reference_plan_numpy(ids, rows))
    assert (got.touched is None) == (mode == "off")


@pytest.mark.pallas
@pytest.mark.parametrize("shape,rows,seed,fill", PLAN_CASES[:4])
def test_plan_kernel_plain_version_matches_pallas_kernel(shape, rows, seed,
                                                         fill):
    """The plan kernel's plain version against the TPU kernel's body under
    the Pallas interpreter: uids, inv, touched bit-equal, rank under
    touched."""
    ids = _ids(shape, rows, seed, fill)
    want = pemb.plan_build_pallas(jnp.asarray(ids), rows, interpret=True)
    got = ek.plan_build_kernel(torch.from_numpy(ids), rows)
    _assert_plan_equal(got, _plan_np(want))


def test_reference_plan_numpy_matches_jax():
    ids = _ids((9, 4), 30, 7, 0.2)
    for a, b in zip(ek.reference_plan_numpy(ids, 30),
                    pemb.reference_plan_numpy(ids, 30)):
        np.testing.assert_array_equal(a, b)


def test_plan_reads_out_of_range_ids_as_fill():
    """An id outside [0, rows] is the fill id rows on every leg (the
    kernel's rule: no id writes outside a buffer)."""
    rows = 20
    ids = np.array([3, -1, 25, 3, 20, 7, -100, 19], np.int32)
    clean = np.where((ids < 0) | (ids > rows), rows, ids).astype(np.int32)
    want = pemb.reference_plan_numpy(clean, rows)
    for mode in ("auto", "xla", "off"):
        _assert_plan_equal(ek.plan_build(torch.from_numpy(ids), rows,
                                         mode=mode), want)


def test_plan_all_fill_and_all_equal():
    for ids, n_real in ((np.full(11, 16, np.int32), 0),
                        (np.full(11, 5, np.int32), 1)):
        p = ek.plan_build(torch.from_numpy(ids), 16)
        assert int(emb.valid_rows(p).sum()) == n_real
        assert torch.all(p.inv == 0)  # one slot: the fill or the one id
        _assert_plan_equal(p, pemb.reference_plan_numpy(ids, 16))


def test_resolve_legs():
    assert ek.resolve("auto", "plan", num_rows=8) == "kernel"
    assert ek.resolve("pallas", "take") == "kernel"
    assert ek.resolve("xla", "plan", num_rows=8) == "opt"
    assert ek.resolve("off", "take") == "ref"
    big = ek.PLAN_COUNT_MAX_ROWS + 1
    assert ek.PLAN_COUNT_MAX_ROWS == pemb.PLAN_COUNT_MAX_ROWS
    assert ek.resolve("auto", "plan", num_rows=big) == "ref"
    assert ek.resolve("auto", "take", num_rows=big) == "kernel"
    assert ek.MODES == pemb.MODES
    with pytest.raises(ValueError, match="embedding_kernels"):
        ek.resolve("bogus", "plan")
    assert ek.plan_build(torch.zeros(4, dtype=torch.int32), big).touched \
        is None


# ---------------------------------------------------------------------------
# Take: gather forward + segment-sum backward
# ---------------------------------------------------------------------------

def _take_inputs(u, n, d, seed):
    rng = np.random.default_rng(seed)
    shape = (u, d) if d else (u,)
    rows = rng.standard_normal(shape).astype(np.float32)
    inv = rng.integers(0, u, (n,)).astype(np.int32)
    g = rng.standard_normal((n,) + shape[1:]).astype(np.float32)
    return rows, inv, g


def _oracle_bwd(g, inv, u):
    out = np.zeros((u,) + g.shape[1:], np.float32)
    for p in range(inv.size):  # the TPU kernel's loop order
        out[inv[p]] += g[p]
    return out


def _port_take(rows, inv, g, mode):
    r = torch.from_numpy(rows).requires_grad_()
    entry = emb.PlanEntry(uids=torch.arange(rows.shape[0], dtype=torch.int32),
                          inv=torch.from_numpy(inv), mask=None,
                          num_rows=rows.shape[0])
    out = emb.lookup_rows(r, entry, mode=mode)
    d_rows, = torch.autograd.grad(out, r, torch.from_numpy(g))
    return out.detach().numpy(), d_rows.numpy()


@pytest.mark.parametrize("d", [0, 1, 4])
@pytest.mark.parametrize("mode", ["auto", "xla", "off"])
def test_take_rows_forward_and_vjp_match_oracle(d, mode):
    """d = 0 is a 1-D table (fm_w), handled as D = 1."""
    rows, inv, g = _take_inputs(17, 40, d, seed=d)
    out, d_rows = _port_take(rows, inv, g, mode)
    np.testing.assert_array_equal(out, rows[inv])
    np.testing.assert_array_equal(d_rows, _oracle_bwd(g, inv, 17))


@pytest.mark.pallas
@pytest.mark.parametrize("d", [1, 4])
def test_take_rows_matches_pallas_kernels(d):
    rows, inv, g = _take_inputs(13, 36, d, seed=10 + d)
    want, vjp = jax.vjp(
        lambda r: pemb.take_rows_pallas(r, jnp.asarray(inv), interpret=True),
        jnp.asarray(rows))
    (want_d,) = vjp(jnp.asarray(g))
    out, d_rows = _port_take(rows, inv, g, "auto")
    np.testing.assert_array_equal(out, np.asarray(want))
    np.testing.assert_array_equal(d_rows, np.asarray(want_d))


def test_take_bwd_plain_version_sums_in_position_order():
    """Values whose float32 sum depends on the order: the plain backward
    adds them in ascending position from 0.0, as the TPU kernel does."""
    g = np.array([[1e8], [1.0], [-1e8], [1.0]], np.float32)
    inv = np.zeros(4, np.int32)
    got = ek.reference_take_bwd(torch.from_numpy(g), torch.from_numpy(inv), 2)
    np.testing.assert_array_equal(got.numpy(), _oracle_bwd(g, inv, 2))
    assert float(got[0, 0]) == 1.0 and float(got[1, 0]) == 0.0


def test_position_segments_group_positions_in_order():
    inv = torch.tensor([2, 0, 2, 1, 0, 2], dtype=torch.int32)
    order, starts = ek.position_segments(inv, 4)
    assert order.tolist() == [1, 4, 3, 0, 2, 5]
    assert starts.tolist() == [0, 2, 3, 6, 6]
    assert order.dtype == starts.dtype == torch.int32


def test_position_segments_leave_out_masked_positions():
    """Slot 3 is a hashed table's fill slot: its masked positions drop out
    of every run, so it walks nothing (its sum of zeros is +0.0 anyway)."""
    inv = torch.tensor([2, 3, 2, 3, 0], dtype=torch.int32)
    keep = torch.tensor([True, False, True, False, True])
    order, starts = ek.position_segments(inv, 4, keep=keep)
    assert starts.tolist() == [0, 1, 1, 3, 3]
    assert order[:3].tolist() == [4, 0, 2]


def test_cpu_takes_launch_no_kernel():
    counts = (ek.plan_launches, ek.take_fwd_launches, ek.take_bwd_launches)
    rows, inv, g = _take_inputs(5, 9, 3, seed=0)
    _port_take(rows, inv, g, "auto")
    ek.plan_build(torch.from_numpy(inv), 5)
    assert (ek.plan_launches, ek.take_fwd_launches,
            ek.take_bwd_launches) == counts


def test_kernel_wrappers_check_their_inputs():
    rows = torch.zeros(4, 2, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ek._check_take(rows, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"rows \[U,D\]"):
        ek._check_take(rows.float()[0], torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Id hashing
# ---------------------------------------------------------------------------

PIN_IDS = [0, 1, 2, 12345, 999_999_937]


def test_hash_golden_pins():
    """The JAX package's frozen values (tests/test_embedding_hash.py)."""
    ids = torch.tensor(PIN_IDS, dtype=torch.int32)
    assert emb.hash_bucket(ids, 1000, salt=1).tolist() == [27, 0, 660, 728,
                                                           564]
    assert emb.hash_bucket(ids, 1000, salt=2).tolist() == [926, 660, 0, 112,
                                                           169]
    assert emb.hash_table_assign(ids, 4).tolist() == [1, 1, 0, 2, 0]


@pytest.mark.parametrize("salt", [1, 2, 5, emb.TABLE_ASSIGN_SALT])
def test_hash_matches_jax_on_negative_and_extreme_ids(salt):
    rng = np.random.default_rng(salt % 97)
    ids = np.concatenate([
        np.array([0, -1, -2, -12345, 2 ** 31 - 1, -2 ** 31, 7], np.int32),
        rng.integers(-2 ** 31, 2 ** 31, 500, dtype=np.int64).astype(np.int32)])
    t, j = torch.from_numpy(ids), jnp.asarray(ids)
    np.testing.assert_array_equal(emb.hash_mix(t, salt).numpy(),
                                  np.asarray(jax_emb.hash_mix(j, salt))
                                  .astype(np.int64))
    for b in (1, 7, 1000, 262144):
        got = emb.hash_bucket(t, b, salt)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax_emb.hash_bucket(j, b, salt)))
    np.testing.assert_array_equal(emb.hash_table_assign(t, 3).numpy(),
                                  np.asarray(jax_emb.hash_table_assign(j, 3)))


def test_mul32_keeps_the_low_32_bits():
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 123456789],
                     dtype=torch.int64)
    for c in (emb._KNUTH, emb._MIX1, emb._MIX2):
        want = [(int(v) * c) % 2 ** 32 for v in x]
        assert emb._mul32(x, c).tolist() == want


# ---------------------------------------------------------------------------
# Row ops
# ---------------------------------------------------------------------------

def _both_plans(ids, rows, mask=None, counting=True):
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jmake = jax_emb.make_plan_counting if counting else jax_emb.make_plan
    tmake = emb.make_plan_counting if counting else emb.make_plan
    return (jmake(jnp.asarray(ids), rows, jm),
            tmake(torch.from_numpy(ids), rows, tm))


@pytest.mark.parametrize("d", [0, 3])
def test_gather_rows_reads_zero_at_fill_slots(d):
    rows = 24
    rng = np.random.default_rng(d)
    table = rng.standard_normal((rows, d) if d else (rows,)).astype(
        np.float32)
    ids = _ids((10, 2), rows, 8, 0.3)
    jp, tp = _both_plans(ids, rows)
    got = emb.gather_rows(torch.from_numpy(table), tp).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_emb.gather_rows(
        jnp.asarray(table), jp)))
    assert np.all(got[~emb.valid_rows(tp).numpy()] == 0)


def test_lookup_rows_masks_like_jax():
    rows = 12
    ids = _ids((6, 3), rows, 9, 0.4)
    mask = (ids < rows).astype(np.float32)
    jp, tp = _both_plans(ids, rows, mask)
    r = np.random.default_rng(1).standard_normal((ids.size, 4)).astype(
        np.float32)
    for mode in ("auto", "off"):
        got = emb.lookup_rows(torch.from_numpy(r), tp, mode=mode).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_emb.lookup_rows(
            jnp.asarray(r), jp)))


@pytest.mark.parametrize("counting", [True, False])
@pytest.mark.parametrize("fill", [0.0, 0.5, 1.0])
def test_scatter_writeback_matches_jax(counting, fill):
    """Scatter (stripped plans) and select (counting plans) writebacks
    place exactly the JAX rows, fill slots dropped, in place. fill=1.0 is a
    table no position reads."""
    rows, d = 20, 3
    rng = np.random.default_rng(int(fill * 10) + counting)
    ids = _ids((6, 3), rows, 6, fill)
    jp, tp = _both_plans(ids, rows, counting=counting)
    table = rng.standard_normal((rows, d)).astype(np.float32)
    new = rng.standard_normal((ids.size, d)).astype(np.float32)
    tau = rng.integers(0, 5, rows).astype(np.int32)
    for strip in (False, True):
        j = jp._replace(touched=None, rank=None) if strip else jp
        t = tp._replace(touched=None, rank=None) if strip else tp
        tt = torch.from_numpy(table.copy())
        assert emb.scatter_rows(tt, t, torch.from_numpy(new)) is tt
        np.testing.assert_array_equal(tt.numpy(), np.asarray(
            jax_emb.scatter_rows(jnp.asarray(table), j, jnp.asarray(new))))
        ttau = torch.from_numpy(tau.copy())
        emb.set_rows_scalar(ttau, t, 9)
        np.testing.assert_array_equal(ttau.numpy(), np.asarray(
            jax_emb.set_rows_scalar(jnp.asarray(tau), j,
                                    jnp.asarray(9, jnp.int32))))
