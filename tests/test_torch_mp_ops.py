"""The model axis's ops (``ops.embedding``: the row exchange, the
owner-local scatter, the row-sharded lookups; ``parallel.mesh``: the
payload accounting) against the JAX package.

The functions without a collective (``build_exchange``,
``owner_scatter_add``) run in this process for every shard index; the
JAX side runs under ``shard_map`` on the suite's virtual CPU mesh, as
``tests/test_embedding_shard.py`` runs it, and beside the JAX package's
sequential oracle ``reference_exchange_numpy``. The collectives run in
2 and 4 gloo rank processes of this file (``test_torch_dp.run_ranks``: a
``file://`` store, hard timeouts). Every comparison is exact: the exchange
and the sharded lookups sum one nonzero part per element, and each
shard's lookup gradient must equal its slice of the one-device gradient
bit for bit, which an all_reduce in the lookup's backward (M times the
gradient) would break.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deepfm_tpu_torch.config import Config  # noqa: E402
from deepfm_tpu_torch.models import common  # noqa: E402
from deepfm_tpu_torch.ops import embedding as emb_ops  # noqa: E402
from deepfm_tpu_torch.parallel import bootstrap  # noqa: E402
from deepfm_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

ROWS = 64
# (label, ids, rows): U = ids.size slots; "fill": many repeats, so most
# slots are fill; "ragged": U = 30, not a multiple of 4.
EXCHANGE_CASES = [("even", 24, 0), ("ragged", 30, 0), ("fill", 30, 6)]
LOOKUP_SHAPE = (8, 5)     # a batch of ids [B, F]
HASHED = "32,16"


def _ids(n, seed, distinct):
    rng = np.random.default_rng(seed)
    if distinct:
        return rng.integers(0, distinct, size=(n,))
    return rng.integers(0, ROWS, size=(n,))


def _plans(n, distinct, seed=5):
    import jax.numpy as jnp  # noqa: PLC0415
    from deepfm_tpu.ops import embedding as jax_emb  # noqa: PLC0415
    ids = _ids(n, seed, distinct)
    jplan = jax_emb.make_plan(jnp.asarray(ids, jnp.int32), ROWS)
    tplan = emb_ops.make_plan(torch.from_numpy(ids.astype(np.int32)), ROWS)
    np.testing.assert_array_equal(tplan.uids.numpy(), np.asarray(jplan.uids))
    return ids, jplan, tplan


def _mesh(d):
    import jax  # noqa: PLC0415
    from jax.sharding import Mesh  # noqa: PLC0415
    return Mesh(np.asarray(jax.devices()[:d]), ("model",))


def _shard_map(f, d, in_specs, out_specs):
    import jax  # noqa: PLC0415
    try:
        from jax import shard_map  # noqa: PLC0415
        return jax.jit(shard_map(f, mesh=_mesh(d), in_specs=in_specs,
                                 out_specs=out_specs))
    except ImportError:  # jax < 0.5 (the JAX package's own shim)
        from jax.experimental.shard_map import shard_map  # noqa: PLC0415
        return jax.jit(shard_map(f, mesh=_mesh(d), in_specs=in_specs,
                                 out_specs=out_specs, check_rep=False))


# ---------------------------------------------------------------------------
# In-process: no collective
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("label,n,distinct", EXCHANGE_CASES,
                         ids=[c[0] for c in EXCHANGE_CASES])
def test_build_exchange_matches_oracle_and_jax(d, label, n, distinct):
    """Every shard's (reqs, flat_idx) equal the sequential oracle's and the
    JAX ``build_exchange``'s under shard_map; the ragged case pads the last
    slice, the fill case routes most slots to the fill id."""
    from jax.sharding import PartitionSpec as P  # noqa: PLC0415
    from deepfm_tpu.ops import embedding as jax_emb  # noqa: PLC0415
    from deepfm_tpu.ops import pallas_embedding as pemb  # noqa: PLC0415
    _, jplan, tplan = _plans(n, distinct)
    if label == "fill":
        assert int((tplan.uids == ROWS).sum()) > n // 2

    def f():
        ex = jax_emb.build_exchange(jplan, d, "model")
        return ex.reqs, ex.flat_idx

    jreqs, jflat = _shard_map(f, d, (), (P("model"), P("model")))()
    jreqs = np.asarray(jreqs).reshape(d, d, -1)
    jflat = np.asarray(jflat).reshape(d, -1)
    for r in range(d):
        ex = emb_ops.build_exchange(tplan, d, r)
        want_reqs, want_flat = pemb.reference_exchange_numpy(
            tplan.uids.numpy(), ROWS, d, r)
        assert ex.reqs.dtype == torch.int32
        np.testing.assert_array_equal(ex.reqs.numpy(), want_reqs)
        np.testing.assert_array_equal(ex.flat_idx.numpy(), want_flat)
        np.testing.assert_array_equal(ex.reqs.numpy(), jreqs[r])
        np.testing.assert_array_equal(ex.flat_idx.numpy(), jflat[r])
        assert (ex.rows_local, ex.num_shards, ex.n_ids) == (ROWS // d, d, n)


def test_build_exchange_rejects_indivisible():
    plan = emb_ops.make_plan(torch.tensor([1, 2], dtype=torch.int32), 65)
    with pytest.raises(ValueError, match="divisible"):
        emb_ops.build_exchange(plan, 2, 0)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("trailing", [(), (3,)], ids=["1d", "2d"])
def test_owner_scatter_add_partitions_full_scatter(d, trailing):
    """The shards' owner-local scatters concatenate to the unsharded
    table-space scatter (one shard, the plain scatter), bit for bit, and
    equal the JAX ``owner_scatter_add`` under shard_map."""
    import jax.numpy as jnp  # noqa: PLC0415
    from jax.sharding import PartitionSpec as P  # noqa: PLC0415
    from deepfm_tpu.ops import embedding as jax_emb  # noqa: PLC0415
    _, jplan, tplan = _plans(20, 0, seed=9)
    rng = np.random.default_rng(9)
    g = rng.normal(size=(20,) + trailing).astype(np.float32)
    full, full_t = emb_ops.owner_scatter_add(torch.from_numpy(g), tplan, 1, 0)
    want = np.zeros((ROWS,) + trailing, np.float32)
    uids = tplan.uids.numpy()
    for j, u in enumerate(uids):
        if u < ROWS:
            want[u] += g[j]
    np.testing.assert_array_equal(full.numpy(), want)
    np.testing.assert_array_equal(full_t.numpy(),
                                  np.isin(np.arange(ROWS), uids))
    parts = [emb_ops.owner_scatter_add(torch.from_numpy(g), tplan, d, r)
             for r in range(d)]
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in parts]).numpy(), full.numpy())
    np.testing.assert_array_equal(
        torch.cat([p[1] for p in parts]).numpy(), full_t.numpy())

    def f():
        return jax_emb.owner_scatter_add(jnp.asarray(g), jplan, d, "model")

    jg, jt = _shard_map(f, d, (), (P("model"), P("model")))()
    np.testing.assert_array_equal(full.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(full_t.numpy(), np.asarray(jt))


@pytest.mark.parametrize("d", [2, 4])
def test_mask_pad_rows_with_shard_offset_matches_jax(d):
    """Pad rows of a 256-row table over a 100-id vocabulary, masked shard
    by shard at each shard's global offset, equal the JAX
    ``mask_pad_rows`` under shard_map (its offset from ``axis_index``)."""
    import jax.numpy as jnp  # noqa: PLC0415
    from jax.sharding import PartitionSpec as P  # noqa: PLC0415
    from deepfm_tpu.ops import embedding as jax_emb  # noqa: PLC0415
    x = np.random.default_rng(3).normal(size=(256, 2)).astype(np.float32)
    rows = 256 // d
    got = np.concatenate([emb_ops.mask_pad_rows(
        torch.from_numpy(x[r * rows:(r + 1) * rows]), 100, r * rows).numpy()
        for r in range(d)])
    want = _shard_map(lambda t: jax_emb.mask_pad_rows(t, 100, "model"), d,
                      (P("model", None),), P("model", None))(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.all(got[100:] == 0) and np.array_equal(got[:100], x[:100])


@pytest.mark.parametrize("n_ids,row_elems,d", [(100, 8, 1), (100, 8, 4),
                                               (39_936, 32, 2),
                                               (39_936, 1, 4), (30, 5, 4)])
def test_exchange_payload_bytes_matches_jax(n_ids, row_elems, d):
    from deepfm_tpu.ops import embedding as jax_emb  # noqa: PLC0415
    assert emb_ops.exchange_payload_bytes(n_ids, row_elems, d) == \
        jax_emb.exchange_payload_bytes(n_ids, row_elems, d)


def _small(**kw):
    base = dict(feature_size=500, field_size=6, embedding_size=8,
                deep_layers="16,8", batch_size=64, compute_dtype="float32")
    base.update(kw)
    return base


@pytest.mark.parametrize("layout", ["mono", "hashed"])
@pytest.mark.parametrize("shard", ["off", "rows"])
@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_grad_payload_bytes_matches_jax(layout, shard, model_size):
    """``mesh.grad_payload_bytes`` over the port's flat params equals the
    JAX package's over its param tree: the dense leg (tables 1/M) and the
    rows leg (owner slices plus one touched mask per physical table)."""
    import jax  # noqa: PLC0415
    from deepfm_tpu.config import Config as JaxConfig  # noqa: PLC0415
    from deepfm_tpu.models import get_model as jax_model  # noqa: PLC0415
    from deepfm_tpu.parallel import mesh as jax_mesh  # noqa: PLC0415
    from deepfm_tpu_torch.models import get_model  # noqa: PLC0415
    kw = _small(**({"embedding_buckets": "256,128"} if layout == "hashed"
                   else {}))
    jm = jax_model(JaxConfig(**kw))
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    names = tuple(jm.embedding_param_names())
    want = jax_mesh.grad_payload_bytes(jparams, names, model_size,
                                       embedding_shard=shard)
    tm = get_model(Config(**kw), device="meta")
    emb = tm.emb
    keys = [emb.param_key(n, k) for n in tm.embedding_param_names()
            for k in emb.table_keys()]
    got = mesh_lib.grad_payload_bytes(dict(tm.named_parameters()), keys,
                                      model_size, embedding_shard=shard)
    assert got == want


@pytest.mark.parametrize("model_size", [1, 2])
@pytest.mark.parametrize("update", ["dense", "sparse"])
def test_pspecs_match_jax(model_size, update):
    """The port's placement (which params and optimizer slots are
    row-sharded over the model axis) equals the JAX package's partition
    specs (dim 0's axis) for the same model, dense and sparse layouts."""
    import jax  # noqa: PLC0415
    from deepfm_tpu.config import Config as JaxConfig  # noqa: PLC0415
    from deepfm_tpu.parallel import mesh as jax_mesh  # noqa: PLC0415
    from deepfm_tpu.train import Trainer as JaxTrainer  # noqa: PLC0415
    from deepfm_tpu_torch.train import Trainer  # noqa: PLC0415
    from deepfm_tpu_torch.utils.params import flatten  # noqa: PLC0415
    kw = _small(embedding_update=update,
                embedding_shard="rows" if update == "sparse" else "off")
    jt = JaxTrainer(JaxConfig(**kw, mesh_data=1, mesh_model=1))
    js = jt.init_state()
    jspecs = jax_mesh.param_pspecs(js.params, tuple(jt._embed_names),
                                   model_size)

    axes = jax.tree.map(lambda spec: spec[0] if len(spec) else "",
                        jspecs, is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
    want = {k: v or None for k, v in flatten(axes).items()}
    tr = Trainer(Config(**kw), device="cpu",
                 mesh_info=mesh_lib.MeshInfo(model_size=model_size))
    assert tr._param_specs == want
    state = tr.init_state()
    specs = tr._opt_specs(state.opt_state)
    axis = mesh_lib.MODEL_AXIS if model_size > 1 else None
    if update == "sparse":
        for n in ("fm_w", "fm_v"):
            e = specs["embed"][n]["table"]
            assert (e.m, e.v, e.tau) == (axis, axis, axis)
        assert all(v is None for v in specs["base"]["mu"].values())
    else:
        for slot in ("mu", "nu"):
            assert {k: v for k, v in specs[slot].items()} == want
    assert mesh_lib.batch_pspecs({"feat_ids": 0, "label": 0}) == {
        "feat_ids": mesh_lib.DATA_AXIS, "label": mesh_lib.DATA_AXIS}


# ---------------------------------------------------------------------------
# Rank processes: the collectives
# ---------------------------------------------------------------------------

def _rank_cases(world, rank, out_dir):
    """Every collective case of one world size, this rank's results."""
    axis = emb_ops.ModelAxis(rank, world, None)
    out = {}
    rng = np.random.default_rng(7)
    for trailing in ((), (5,)):
        table = torch.from_numpy(rng.normal(
            size=(ROWS,) + trailing).astype(np.float32))
        for label, n, distinct in EXCHANGE_CASES:
            ids = _ids(n, 11, distinct)
            plan = emb_ops.make_plan(torch.from_numpy(ids.astype(np.int32)),
                                     ROWS)
            ex = emb_ops.build_exchange(plan, world, rank)
            got = emb_ops.exchange_rows(emb_ops.shard_rows(table, axis), ex,
                                        axis)
            out[f"exchange.{label}.{len(trailing)}"] = got.numpy()
    for strategy in ("masked_psum", "allgather_table"):
        for trailing in ((), (5,)):
            full = torch.from_numpy(rng.normal(
                size=(ROWS,) + trailing).astype(np.float32))
            ids = torch.from_numpy(rng.integers(
                -ROWS, ROWS, size=LOOKUP_SHAPE).astype(np.int32))
            ids[0, 0] = ROWS + 3        # out of range: a NaN row
            cot = torch.from_numpy(rng.normal(
                size=LOOKUP_SHAPE + trailing).astype(np.float32))
            local = emb_ops.shard_rows(full, axis).requires_grad_()
            if strategy == "masked_psum":
                y = emb_ops.sharded_lookup(local, ids, axis)
            else:
                y = emb_ops.sharded_lookup_allgather(local, ids, axis)
            ok = torch.isfinite(y)
            torch.sum(torch.where(ok, y, torch.zeros(())) * cot).backward()
            key = f"lookup.{strategy}.{len(trailing)}"
            out[key + ".y"] = y.detach().numpy()
            out[key + ".g"] = local.grad.numpy()
    # The hashed layout's dense lookup: every bucket table masked locally,
    # one sum for all of them.
    cfg = Config(**_small(embedding_buckets=HASHED))
    schema = common.EmbeddingSchema(cfg)
    feat = torch.from_numpy(rng.integers(0, 500, size=LOOKUP_SHAPE)
                            .astype(np.int32))
    tabs = {k: torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32))
            for k, b in zip(schema.table_keys(), schema.buckets)}
    cot = torch.from_numpy(rng.normal(size=LOOKUP_SHAPE + (3,)).astype(
        np.float32))
    local = {k: emb_ops.shard_rows(t, axis).requires_grad_()
             for k, t in tabs.items()}
    y = schema.lookup(local, feat, axis=axis)
    torch.sum(y * cot).backward()
    out["hashed.y"] = y.detach().numpy()
    for k, t in local.items():
        out[f"hashed.g.{k}"] = t.grad.numpy()
    np.savez(os.path.join(out_dir, f"ops.{world}.{rank}.npz"), **out)


def _rank_main(spec_path, rank):
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    bootstrap.initialize(Config(
        dist_mode=1, num_processes=world, process_id=rank,
        coordinator_address="file://" + spec["store"]), device="cpu")
    _rank_cases(world, rank, spec["out"])
    bootstrap.barrier()
    bootstrap.destroy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_dp import run_ranks  # noqa: PLC0415
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"mpops{world}")
        run_ranks(world, {}, tmp, script=os.path.abspath(__file__))
        out[world] = [dict(np.load(tmp / f"ops.{world}.{r}.npz"))
                      for r in range(world)]
    return out


def _full_reference(world):
    """The one-device results of every rank case (same draws)."""
    rng = np.random.default_rng(7)
    out = {}
    for trailing in ((), (5,)):
        table = torch.from_numpy(rng.normal(
            size=(ROWS,) + trailing).astype(np.float32))
        for label, n, distinct in EXCHANGE_CASES:
            ids = _ids(n, 11, distinct)
            plan = emb_ops.make_plan(torch.from_numpy(ids.astype(np.int32)),
                                     ROWS)
            out[f"exchange.{label}.{len(trailing)}"] = (
                emb_ops.gather_rows(table, plan).numpy(), table, plan)
    for strategy in ("masked_psum", "allgather_table"):
        for trailing in ((), (5,)):
            full = torch.from_numpy(rng.normal(
                size=(ROWS,) + trailing).astype(np.float32))
            ids = torch.from_numpy(rng.integers(
                -ROWS, ROWS, size=LOOKUP_SHAPE).astype(np.int32))
            ids[0, 0] = ROWS + 3
            cot = torch.from_numpy(rng.normal(
                size=LOOKUP_SHAPE + trailing).astype(np.float32))
            t = full.clone().requires_grad_()
            y = emb_ops.lookup(t, ids)
            ok = torch.isfinite(y)
            torch.sum(torch.where(ok, y, torch.zeros(())) * cot).backward()
            out[f"lookup.{strategy}.{len(trailing)}"] = (
                y.detach().numpy(), t.grad.numpy())
    cfg = Config(**_small(embedding_buckets=HASHED))
    schema = common.EmbeddingSchema(cfg)
    feat = torch.from_numpy(rng.integers(0, 500, size=LOOKUP_SHAPE)
                            .astype(np.int32))
    tabs = {k: torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32)
                                ).requires_grad_()
            for k, b in zip(schema.table_keys(), schema.buckets)}
    cot = torch.from_numpy(rng.normal(size=LOOKUP_SHAPE + (3,)).astype(
        np.float32))
    y = schema.lookup(tabs, feat)
    torch.sum(y * cot).backward()
    out["hashed"] = (y.detach().numpy(),
                     {k: t.grad.numpy() for k, t in tabs.items()})
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", [c[0] for c in EXCHANGE_CASES])
@pytest.mark.parametrize("ndim", [0, 1], ids=["1d", "2d"])
def test_exchange_rows_bit_equals_gather_rows(ranks, world, label, ndim):
    """``exchange_rows`` over M ranks (two all_to_alls and one all_reduce
    over gloo) returns, on every rank, the plan's rows exactly as
    ``gather_rows`` reads them from the full table (fill slots zero), and
    as the JAX ``gather_rows`` does."""
    import jax.numpy as jnp  # noqa: PLC0415
    from deepfm_tpu.ops import embedding as jax_emb  # noqa: PLC0415
    want, table, plan = _full_reference(world)[f"exchange.{label}.{ndim}"]
    jplan = jax_emb.make_plan(jnp.asarray(plan.uids.numpy()), ROWS)
    jwant = np.asarray(jax_emb.gather_rows(jnp.asarray(table.numpy()),
                                           jplan._replace(uids=jnp.asarray(
                                               plan.uids.numpy()))))
    np.testing.assert_array_equal(want, jwant)
    for r in range(world):
        np.testing.assert_array_equal(
            ranks[world][r][f"exchange.{label}.{ndim}"], want)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("strategy", ["masked_psum", "allgather_table"])
@pytest.mark.parametrize("ndim", [0, 1], ids=["1d", "2d"])
def test_sharded_lookup_forward_and_shard_gradient(ranks, world, strategy,
                                                   ndim):
    """The row-sharded lookup equals the one-device lookup on every rank
    (NaN rows for out-of-range ids, wrapped negative ids), and each rank's
    table gradient equals its slice of the one-device table gradient, bit
    for bit: the backward adds no collective (an all_reduce there would
    make it ``world`` times too large)."""
    y, g = _full_reference(world)[f"lookup.{strategy}.{ndim}"]
    rows = ROWS // world
    for r in range(world):
        got = ranks[world][r]
        np.testing.assert_array_equal(
            got[f"lookup.{strategy}.{ndim}.y"], y)
        np.testing.assert_array_equal(
            got[f"lookup.{strategy}.{ndim}.g"], g[r * rows:(r + 1) * rows])


@pytest.mark.parametrize("world", [2, 4])
def test_hashed_sharded_lookup_one_sum(ranks, world):
    """The hashed layout's sharded lookup (each table masked locally, one
    sum for every table) equals the one-device lookup, and each table's
    shard gradient is its slice of the one-device gradient."""
    y, grads = _full_reference(world)["hashed"]
    for r in range(world):
        got = ranks[world][r]
        np.testing.assert_array_equal(got["hashed.y"], y)
        for k, g in grads.items():
            rows = g.shape[0] // world
            np.testing.assert_array_equal(got[f"hashed.g.{k}"],
                                          g[r * rows:(r + 1) * rows])


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
