"""The take backward over several tables and the cache install over both
of a transaction's tables (``embedding_kernels.position_segments_tables``,
``TakeRowsSum``'s backward, ``install_rows_tables``) against the JAX
package and the port's own per-table versions, on the CPU; and the
position-order segment sums that replace float atomics in the dense
lookups' and the monolithic fused leg's gradients (``index_rows``,
``segment_sum``).

On the CPU the wrappers take their plain versions: ``reference_take_bwd``
per table and ``index_add_`` (which add one position after another, the
kernel's ascending order) and ``reference_install`` per table. Segments
and installs are integer work and copies, and the sums repeat the JAX
package's float32 adds in its order, so every comparison here is
bit-equal. The Pallas kernels run through the Pallas interpreter (the
``pallas`` marker), as ``tests/test_pallas_embedding.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.data import hot_cold as jhc
from deepfm_tpu.models import common as jax_common
from deepfm_tpu.ops import pallas_embedding as pemb
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.models import common
from deepfm_tpu_torch.ops import embedding as emb
from deepfm_tpu_torch.ops import embedding_kernels as ek

torch.set_num_threads(1)

B, F = 24, 5
UNEQUAL = "97,7,1,300"   # four hashed tables of unequal rows
ARGS = ("w", "m", "v", "tau", "slots", "wv", "mv", "vv", "tv")


def _schemas(buckets):
    kw = dict(feature_size=10 ** 6, field_size=F, embedding_size=4,
              embedding_update="sparse", embedding_buckets=buckets,
              embedding_assign="hash")
    return (jax_common.EmbeddingSchema(JaxConfig(**kw)),
            common.EmbeddingSchema(Config(**kw)))


def _feat_ids(seed):
    return np.random.default_rng(seed).integers(0, 10 ** 6, (B, F)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# Position segments of every table in one build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 3, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_segments_tables_equal_position_segments_per_table(t, masked):
    """One sort for T tables gives each table's (order, starts) of
    ``position_segments`` bit for bit, with and without ``keep``."""
    rng = np.random.default_rng(10 * t + masked)
    n = 60
    inv = rng.integers(0, n // 3, (t, n)).astype(np.int32)
    keep = rng.random((t, n)) < 0.4 if masked else None
    got = ek.position_segments_tables(
        torch.from_numpy(inv), n,
        None if keep is None else torch.from_numpy(keep))
    assert len(got) == t
    for i, (order, starts) in enumerate(got):
        want = ek.position_segments(
            torch.from_numpy(inv[i]), n,
            None if keep is None else torch.from_numpy(keep[i]))
        assert order.dtype == starts.dtype == torch.int32
        assert torch.equal(order, want[0]) and torch.equal(starts, want[1])


def test_segments_tables_of_a_hashed_plan():
    """The four hashed tables' plans: stacked inv and masks through one
    build equal each entry's own segments, masked positions left out."""
    _, ts = _schemas(UNEQUAL)
    plan = ts.sparse_plan(torch.from_numpy(_feat_ids(4)))
    entries = list(plan.values())
    n = B * F
    got = ek.position_segments_tables(
        torch.stack([e.inv.reshape(-1) for e in entries]), n,
        torch.stack([e.mask.reshape(-1) > 0 for e in entries]))
    for e, (order, starts) in zip(entries, got):
        want = ek.position_segments(e.inv, n, keep=e.mask > 0)
        assert torch.equal(order, want[0]) and torch.equal(starts, want[1])
        # Every kept position sits in one run; the masked ones in none.
        assert int(starts[-1]) == int((e.mask > 0).sum())


def test_segments_tables_refuse_an_int32_overflow():
    inv = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows int32"):
        ek.position_segments_tables(inv, 2 ** 28)
    ek.position_segments_tables(inv, 2 ** 27)  # 8 * (2^27 + 1) fits


# ---------------------------------------------------------------------------
# TakeRowsSum's gradients per table
# ---------------------------------------------------------------------------

def _gathered(plan, d, seed):
    """Per table: rows [N, d] (or [N] at d = 0, the 1-D fm_w) with the fill
    slots zero, as ``gather_rows`` hands them over."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, e in plan.items():
        r = rng.standard_normal((B * F, d) if d else (B * F,)).astype(
            np.float32)
        r[np.asarray(e.uids) >= e.num_rows] = 0.0
        out[k] = r
    return out


def _take_grads(tplan, rows, g, with_segments):
    """TakeRowsSum's per-table gradients over all of ``tplan``'s tables at
    once, given the plan's segments (as the card's step does) or not."""
    keys = list(tplan)
    leaves = [torch.from_numpy(rows[k]).requires_grad_() for k in keys]
    segments = None
    if with_segments:
        segments = ek.position_segments_tables(
            torch.stack([tplan[k].inv.reshape(-1) for k in keys]), B * F,
            torch.stack([tplan[k].mask.reshape(-1) > 0 for k in keys]))
    out = ek.take_rows_sum(leaves, [tplan[k].inv for k in keys],
                           [tplan[k].mask for k in keys], segments)
    return dict(zip(keys, torch.autograd.grad(out, leaves,
                                              torch.from_numpy(g))))


@pytest.mark.pallas
@pytest.mark.parametrize("d", [0, 1, 8])
def test_take_rows_sum_grads_match_pallas_take_vjp(d):
    """Each table's gradient equals the JAX ``take_rows_pallas`` VJP (the
    TPU kernel's segment sum, in the Pallas interpreter) at g * mask_t."""
    _, ts = _schemas(UNEQUAL)
    tplan = ts.sparse_plan(torch.from_numpy(_feat_ids(3)))
    rows = _gathered(tplan, d, 3)
    g = np.random.default_rng(13).standard_normal(
        (B, F) + ((d,) if d else ())).astype(np.float32)
    grads = _take_grads(tplan, rows, g, with_segments=True)
    for k, e in tplan.items():
        r2 = rows[k] if d else rows[k][:, None]
        mask = e.mask.numpy()
        gm = (g if d else g[..., None]) * mask[..., None]
        _, vjp = jax.vjp(lambda r, inv=jnp.asarray(e.inv.numpy()):
                         pemb.take_rows_pallas(r, inv, True),
                         jnp.asarray(r2))
        want, = vjp(jnp.asarray(gm))
        np.testing.assert_array_equal(grads[k].numpy().reshape(want.shape),
                                      np.asarray(want), err_msg=k)


@pytest.mark.parametrize("d", [0, 1, 8])
@pytest.mark.parametrize("with_segments", [False, True])
def test_take_rows_sum_grads_match_jax_lookup_rows_vjp(d, with_segments):
    """Each table's gradient equals ``jax.vjp`` of the JAX schema's
    ``lookup_rows``, with or without the plan's segments."""
    js, ts = _schemas(UNEQUAL)
    ids = _feat_ids(8)
    jplan = js.sparse_plan(jnp.asarray(ids))
    tplan = ts.sparse_plan(torch.from_numpy(ids))
    rows = _gathered(tplan, d, 8)
    g = np.random.default_rng(18).standard_normal(
        (B, F) + ((d,) if d else ())).astype(np.float32)
    _, vjp = jax.vjp(lambda r: js.lookup_rows(r, jplan),
                     {k: jnp.asarray(v) for k, v in rows.items()})
    want, = vjp(jnp.asarray(g))
    grads = _take_grads(tplan, rows, g, with_segments)
    for k in tplan:
        np.testing.assert_array_equal(grads[k].numpy(), np.asarray(want[k]))


def test_cpu_take_backward_and_install_launch_no_kernel():
    counts = (ek.take_bwd_launches, ek.install_launches)
    _, ts = _schemas(UNEQUAL)
    tplan = ts.sparse_plan(torch.from_numpy(_feat_ids(2)))
    g = np.ones((B, F, 2), np.float32)
    _take_grads(tplan, _gathered(tplan, 2, 2), g, with_segments=True)
    host = _tier_case(8, 16, 5, 8, "padded", 3)
    tabs = [{k: torch.from_numpy(v) for k, v in h.items()} for h in host]
    ek.install_rows_tables(*_split(tabs), mode="auto")
    assert (ek.take_bwd_launches, ek.install_launches) == counts


# ---------------------------------------------------------------------------
# One install for both tables of a transaction
# ---------------------------------------------------------------------------

def _tier_case(d, h, n, p, kind, seed):
    """One transaction of the tier's two tables, fm_w (1-D) and fm_v
    [H, d], over one slots array: n distinct real slots padded to p at the
    out-of-range slot h ("padded"), or only out-of-range slots
    ("out_of_range"). Every slot carries values, so a dropped slot that was
    written would show."""
    rng = np.random.default_rng(seed)
    slots = np.full((p,), h, np.int32)
    if kind == "padded":
        slots[:n] = rng.choice(h, n, replace=False)
        slots[n + 1] = h + 3
    else:
        slots[1::2] = 2 ** 31 - 1
    f = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = []
    for trail in ((), (d,)):
        out.append({"w": f((h,) + trail), "m": f((h,) + trail),
                    "v": np.abs(f((h,) + trail)),
                    "tau": rng.integers(0, 9, h).astype(np.int32),
                    "slots": slots, "wv": f((p,) + trail),
                    "mv": f((p,) + trail), "vv": np.abs(f((p,) + trail)),
                    "tv": rng.integers(10, 20, p).astype(np.int32)})
    return out


def _split(tabs):
    """(tables, slots, values) of ``install_rows_tables``."""
    return ([tuple(t[k] for k in ARGS[:4]) for t in tabs], tabs[0]["slots"],
            [tuple(t[k] for k in ARGS[5:]) for t in tabs])


def _assert_bits(got, want, what=""):
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                  err_msg=what)


@pytest.mark.parametrize("kind", ["padded", "out_of_range"])
@pytest.mark.parametrize("leg", ["auto", "pallas", "xla", "off"])
def test_install_rows_tables_match_jax_installs(leg, kind):
    """fm_w and fm_v in one call, in place, bit-equal per table to the JAX
    ``_install_fused_xla`` and ``_jit_install`` x4 and to
    ``reference_install``, out-of-range slots dropped."""
    host = _tier_case(32, 64, 20, 32, kind, 5)
    tabs = [{k: torch.from_numpy(v.copy()) for k, v in h.items()}
            for h in host]
    ek.install_rows_tables(*_split(tabs), mode=leg)
    for h, t in zip(host, tabs):
        j = {k: jnp.asarray(v) for k, v in h.items()}
        fused = pemb._install_fused_xla(*(j[k] for k in ARGS))
        ref = {k: torch.from_numpy(v.copy()) for k, v in h.items()}
        ek.reference_install(*(ref[k] for k in ARGS))
        for key, vkey, want in zip(ARGS[:4], ARGS[5:], fused):
            _assert_bits(t[key].numpy(), np.asarray(want), key)
            _assert_bits(t[key].numpy(), np.asarray(jhc._jit_install(
                j[key], j["slots"], j[vkey])), key)
            _assert_bits(t[key].numpy(), ref[key].numpy(), key)


@pytest.mark.pallas
def test_install_rows_tables_match_pallas_kernel():
    """fm_v at D = 32 against the TPU install kernel in the interpreter
    (which cannot take the 1-D fm_w: that table against the fused XLA
    install), both from one call."""
    host = _tier_case(32, 48, 12, 16, "padded", 6)
    tabs = [{k: torch.from_numpy(v.copy()) for k, v in h.items()}
            for h in host]
    ek.install_rows_tables(*_split(tabs))
    jw, jv = ({k: jnp.asarray(v) for k, v in h.items()} for h in host)
    want_w = pemb._install_fused_xla(*(jw[k] for k in ARGS))
    want_v = pemb.install_pallas(*(jv[k] for k in ARGS), interpret=True)
    for t, want in zip(tabs, (want_w, want_v)):
        for key, x in zip(ARGS[:4], want):
            _assert_bits(t[key].numpy(), np.asarray(x), key)


def test_install_rows_tables_drop_negative_slots():
    """A negative slot is dropped as an out-of-range one is (the JAX
    ``.at[]`` would wrap it; the tier never stages one)."""
    host = _tier_case(4, 16, 5, 8, "padded", 7)
    for h in host:
        h["slots"][6] = -1
    tabs = [{k: torch.from_numpy(v.copy()) for k, v in h.items()}
            for h in host]
    ek.install_rows_tables(*_split(tabs))
    real = host[0]["slots"][:5]
    for h, t in zip(host, tabs):
        for key, vkey in zip(ARGS[:4], ARGS[5:]):
            want = h[key].copy()
            want[real] = h[vkey][:5]
            _assert_bits(t[key].numpy(), want, key)


@pytest.mark.parametrize("case", ["no_tables", "too_many", "values",
                                  "rows", "dtype", "shape"])
def test_install_rows_tables_checks_its_inputs(case):
    tabs = [{k: torch.from_numpy(v) for k, v in h.items()}
            for h in _tier_case(4, 16, 5, 8, "padded", 8)]
    tables, slots, values = _split(tabs)
    err = ValueError
    if case == "no_tables":
        tables, values = [], []
    elif case == "too_many":
        tables, values = tables * 5, values * 5
    elif case == "values":
        values = values[:1]
    elif case == "rows":
        tables[1] = tuple(x[:8] for x in tables[1])
    elif case == "dtype":
        values[1] = (values[1][0].double(),) + values[1][1:]
        err = TypeError
    else:
        values[0] = (values[0][0][:3],) + values[0][1:]
    with pytest.raises(err):
        ek._check_install_tables(tables, slots, values)


@pytest.mark.parametrize("case", ["no_tables", "too_many", "slot_counts",
                                  "g_dtype", "g_rank", "order_dtype",
                                  "starts_len", "layout"])
def test_take_bwd_tables_checks_its_inputs(case):
    n, u = 6, 5
    g = torch.zeros(n, 3)
    segs = [ek.position_segments(torch.zeros(n, dtype=torch.int32), u)
            for _ in range(2)]
    slots = [u, u]
    err = ValueError
    if case == "no_tables":
        segs, slots = [], []
    elif case == "too_many":
        segs, slots = segs * 5, slots * 5
    elif case == "slot_counts":
        slots = slots[:1]
    elif case == "g_dtype":
        g, err = g.double(), TypeError
    elif case == "g_rank":
        g, err = torch.zeros(n), TypeError
    elif case == "order_dtype":
        segs[1] = (segs[1][0].long(), segs[1][1])
    elif case == "starts_len":
        slots[0] = u + 1
    else:
        segs[0] = (torch.zeros(2 * n, dtype=torch.int32)[::2], segs[0][1])
    with pytest.raises(err):
        ek._check_take_bwd(g, segs, slots)


# ---------------------------------------------------------------------------
# Position-order segment sums in place of float atomics: the dense lookups
# and the monolithic table's fused leg
# ---------------------------------------------------------------------------

def _lookup_with_index_select(table, ids):
    """``emb.lookup``'s ops with ``index_select``'s own backward (the
    gradient route the port took before ``index_rows``)."""
    v = table.shape[0]
    ids = ids.long()
    ok = (ids >= -v) & (ids < v)
    safe = torch.where(ok, torch.where(ids < 0, ids + v, ids),
                       torch.zeros((), dtype=ids.dtype))
    out = table.index_select(0, safe.reshape(-1)).reshape(
        *ids.shape, *table.shape[1:])
    ok = ok.reshape(*ids.shape, *([1] * (table.dim() - 1)))
    return torch.where(ok, out, torch.full((), float("nan")))


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_lookup_gradient_equals_index_select_and_jnp_take(trailing):
    """The dense lookup's gradient through ``index_rows`` (repeated,
    wrapped and out-of-range ids) equals ``index_select``'s backward and
    the VJP of ``jnp.take`` bit for bit; the forward is unchanged."""
    v = 8
    rng = np.random.default_rng(21)
    table = rng.standard_normal((v,) + trailing).astype(np.float32)
    ids = np.array([[3, -1, v, -v, 3, 5], [-v - 1, 0, v - 1, 1000, 3, -1]],
                   np.int32)
    g = rng.standard_normal(ids.shape + trailing).astype(np.float32)
    a = torch.from_numpy(table).requires_grad_()
    b = torch.from_numpy(table).requires_grad_()
    out_a = emb.lookup(a, torch.from_numpy(ids))
    out_b = _lookup_with_index_select(b, torch.from_numpy(ids))
    np.testing.assert_array_equal(out_a.detach().numpy(),
                                  out_b.detach().numpy())
    ga, = torch.autograd.grad(out_a, a, torch.from_numpy(g))
    gb, = torch.autograd.grad(out_b, b, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda x: jnp.take(x, jnp.asarray(ids), axis=0),
                     jnp.asarray(table))
    want, = vjp(jnp.asarray(g))
    _assert_bits(ga.numpy(), gb.numpy())
    _assert_bits(ga.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["auto", "xla", "off"])
@pytest.mark.parametrize("trailing", [(), (34,)])
def test_segment_sum_equals_index_add(mode, trailing):
    """On CPU tensors every leg is ``index_add_`` into zeros, which adds
    one position after another: bit-equal to the numpy ascending-p
    oracle."""
    rng = np.random.default_rng(22)
    ids = rng.integers(0, 9, 80)
    g = rng.standard_normal((80,) + trailing).astype(np.float32)
    got = ek.segment_sum(torch.from_numpy(g), torch.from_numpy(ids), 10,
                         mode=mode)
    want = torch.zeros((10,) + trailing).index_add_(
        0, torch.from_numpy(ids), torch.from_numpy(g))
    oracle = np.zeros((10,) + trailing, np.float32)
    np.add.at(oracle, ids, g)
    _assert_bits(got.numpy(), want.numpy())
    _assert_bits(got.numpy(), oracle)


def test_index_rows_without_grad_is_index_select():
    table = torch.arange(12.0).reshape(6, 2)
    idx = torch.tensor([5, 0, 5])
    assert torch.equal(ek.index_rows(table, idx), table.index_select(0, idx))
    leaf = table.clone().requires_grad_()
    with torch.no_grad():
        out = ek.index_rows(leaf, idx)
    assert not out.requires_grad


class _JaxNames:
    """The one attribute the JAX ``Trainer._fused_grad_ext`` reads."""
    _embed_names = ("fm_w", "fm_v")


def test_fused_grad_ext_matches_jax_and_index_add():
    """The monolithic table's fused leg on the CPU: one segment sum over
    rows + 1 slots (wrapped ids land on id + V, out-of-range ones on the
    dropped extra row) equals the JAX package's ``_fused_grad_ext`` and
    the port's previous ``index_add_`` bit for bit."""
    from deepfm_tpu.train.loop import Trainer as JaxTrainer
    from deepfm_tpu_torch.train import Trainer

    rows, k = 64, 4
    trainer = Trainer(Config(feature_size=60, field_size=F, embedding_size=k,
                             deep_layers="8", embedding_update="sparse"),
                      device="cpu")
    assert tuple(trainer._embed_names) == _JaxNames._embed_names
    rng = np.random.default_rng(23)
    ids = rng.integers(0, rows, (B, F)).astype(np.int32)
    ids[0, :3] = [-1, -rows, rows + 4]
    ids[1, 0] = 2 ** 31 - 1
    views = {"fm_w": rng.standard_normal((B, F)).astype(np.float32),
             "fm_v": rng.standard_normal((B, F, k)).astype(np.float32)}
    tabs = {"fm_w": torch.zeros(rows), "fm_v": torch.zeros(rows, k)}
    got = trainer._fused_grad_ext(tabs, torch.from_numpy(ids),
                                  {n: torch.from_numpy(v)
                                   for n, v in views.items()})
    want = JaxTrainer._fused_grad_ext(
        _JaxNames(), {n: jnp.zeros(t.shape) for n, t in tabs.items()},
        jnp.asarray(ids), {n: jnp.asarray(v) for n, v in views.items()})
    _assert_bits(got.numpy(), np.asarray(want))
    flat = torch.from_numpy(ids).reshape(-1).long()
    flat = torch.where(flat < 0, flat + rows, flat)
    flat = torch.where((flat >= 0) & (flat < rows), flat, rows)
    gcat = torch.cat([torch.ones(B * F, 1)] + [
        torch.from_numpy(views[n]).reshape(B * F, -1)
        for n in _JaxNames._embed_names], 1)
    before = torch.zeros(rows + 1, gcat.shape[1]).index_add_(0, flat, gcat)
    _assert_bits(got.numpy(), before[:rows].numpy())
