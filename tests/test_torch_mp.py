"""The model axis's trainer (``--mesh_model M``, the embedding tables
row-sharded, composed with ``--mesh_data D``) over gloo rank processes on
the CPU, against the port's own one-device run and the JAX package.

Each mesh (1x2, 1x4, 2x2, 2x1) is one launch of D * M rank processes of
this file (``test_torch_dp.run_ranks``: a ``file://`` store, hard
timeouts); rank (d, m) trains on rows ``[d * B/D, (d + 1) * B/D)`` of every
global batch, at the small size of ``tests/test_embedding_shard.py``
(``feature_size=500``, F=6, K=8, B=64), float32, dropout off, from the
JAX-initialized weights (``params_from_jax``). The legs:

  * ``dense`` / ``allgather``: the dense update over ``--embedding_lookup
    masked_psum`` / ``allgather_table``;
  * ``rows`` / ``rows_hashed``: ``--embedding_update sparse
    --embedding_shard rows``, monolithic and hashed (256 + 128 rows);
  * ``din``: DIN on the dense update at 1x2.

Held (the tolerances of ``tests/test_embedding_shard.py`` and of
``tests/test_torch_dp.py``): model-only meshes bit-equal to the port's one
device (params, the gathered full state; on the CPU that needs shard
heights that are multiples of 32, as 512 / 4 is here: torch's vectorized
``exp2``, in the fused leg's shared decay, takes another route for a
tensor's last partial block of 32); every mesh against the JAX
single-device Trainer on the global batch (rtol 1e-3 / atol 1e-5, fm_b
rtol 5e-3 / atol 2e-4), and the model-only legs against the JAX 1x2
Trainer too (rtol 1e-3 / atol 1e-5). The JAX 4x2 trajectory fails on the
reference side, so data x model meshes are held against one device only.
A 1x2 checkpoint restores bit-exactly at 1x1, 1x4 and 2x2 (params and
m/v/tau) and trains on.
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
from deepfm_tpu_torch.parallel import bootstrap  # noqa: E402
from deepfm_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from deepfm_tpu_torch.train import Trainer, tasks  # noqa: E402
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

B, L, STEPS = 64, 5, 6
FM_B_TOL = dict(rtol=5e-3, atol=2e-4)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
EVAL_LOSS_TOL = 1e-6
PRED_TOL = 1e-6
RANK_TIMEOUT_S = 150

LEGS = {
    "dense": {},
    "allgather": dict(embedding_lookup="allgather_table"),
    "rows": dict(embedding_update="sparse", embedding_shard="rows"),
    "rows_hashed": dict(embedding_update="sparse", embedding_shard="rows",
                        embedding_buckets="256,128"),
    "din": dict(model="din", history_max_len=L),
}
# (D, M) -> legs; the 1x2 launch also writes the checkpoints the others
# restore.
MESHES = {
    (1, 2): ("dense", "allgather", "rows", "rows_hashed", "din"),
    (1, 4): ("dense", "allgather", "rows", "rows_hashed"),
    (2, 2): ("dense", "rows", "rows_hashed"),
    (2, 1): ("rows", "rows_hashed"),
}
CKPT_LEGS = ("dense", "rows")
# Legs held against the JAX 1x2 Trainer as well.
JAX_MP2 = ("dense", "allgather", "rows", "rows_hashed")


def _kw(**kw):
    base = dict(feature_size=500, field_size=6, embedding_size=8,
                deep_layers="16,8", dropout="1.0,1.0", batch_size=B,
                compute_dtype="float32", l2_reg=1e-4, learning_rate=0.01,
                shuffle_buffer=500, log_steps=0, seed=11,
                scale_lr_by_world=False, steps_per_loop=2,
                transfer_ahead=0)
    base.update(kw)
    return base


def _batches(n, seed, hist=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"feat_ids": rng.randint(0, 500, (B, 6)).astype(np.int32),
             "feat_vals": rng.rand(B, 6).astype(np.float32),
             "label": (rng.rand(B, 1) < 0.3).astype(np.float32)}
        if hist:
            lens = rng.randint(0, L + 1, B)
            mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
            b["hist_ids"] = (rng.randint(0, 500, (B, L)) * mask).astype(
                np.int32)
            b["hist_mask"] = mask
        out.append(b)
    return out


def _rows(batches, d, data):
    local = B // data
    return [{k: v[d * local:(d + 1) * local] for k, v in b.items()}
            for b in batches]


def _weights(path):
    w = np.load(path)
    return ({k[2:]: torch.from_numpy(w[k]) for k in w.files
             if k.startswith("p.")},
            {k[2:]: torch.from_numpy(w[k]) for k in w.files
             if k.startswith("s.")})


def _flat_opt(tree, prefix="o"):
    """{"o.<path>": array} of an optimizer state (records as dicts)."""
    out = {}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_opt(v, f"{prefix}.{k}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().numpy()
    return out


def _state_arrays(state):
    arr = {f"p.{k}": v.detach().numpy() for k, v in state.params.items()}
    arr.update({f"s.{k}": v.numpy() for k, v in state.model_state.items()})
    arr.update(_flat_opt(state.opt_state))
    return arr


# ---------------------------------------------------------------------------
# The rank processes
# ---------------------------------------------------------------------------

def _rank_leg(spec, leg, data, model, rank, out):
    cfg = Config(**_kw(**LEGS[leg], mesh_data=data, mesh_model=model))
    tr = Trainer(cfg, device="cpu")
    mi = tr.mesh_info
    assert (mi.data_size, mi.model_size) == (data, model)
    assert tr.sparse_embed == (cfg.embedding_update == "sparse")
    params, mstate = _weights(spec["weights"][leg])
    state = tr.load_weights(tr.init_state(), params, mstate)
    hist = leg == "din"
    glob = _batches(STEPS, seed=3, hist=hist)
    state, res = tr.fit(state, _rows(glob, mi.data_index, data))
    ev = tr.evaluate(state, _rows(_batches(2, seed=9, hist=hist),
                                  mi.data_index, data))
    probs = np.concatenate(list(tr.predict(
        state, _rows(_batches(2, seed=9, hist=hist), mi.data_index, data))))
    full = tr.full_state(state)
    tag = f"{leg}.{data}x{model}"
    np.savez(os.path.join(out, f"{tag}.{rank}.npz"), probs=probs,
             **_state_arrays(full))
    with open(os.path.join(out, f"{tag}.{rank}.json"), "w") as f:
        json.dump({"fit": {k: v for k, v in res.items()
                           if isinstance(v, (int, float, str))},
                   "eval": ev, "step": int(state.step),
                   "local_rows": {k: int(v.shape[0])
                                  for k, v in state.params.items()}}, f)
    if leg in CKPT_LEGS and (data, model) == (1, 2):
        mgr = ckpt_lib.CheckpointManager(spec["ckpt"][leg], async_save=False)
        mgr.save(int(state.step), tr.full_state(state), force=True)
        mgr.close()
    elif leg in CKPT_LEGS and (data, model) in ((1, 4), (2, 2)):
        mgr = ckpt_lib.CheckpointManager(spec["ckpt"][leg])
        restored = mgr.restore(tr.init_state(), shard=tr.local_snapshot)
        np.savez(os.path.join(out, f"restored.{tag}.{rank}.npz"),
                 **_state_arrays(tr.full_state(restored)))
        restored, res2 = tr.fit(restored, _rows(
            _batches(2, seed=5), mi.data_index, data))
        assert np.isfinite(res2["loss"]) and restored.step == STEPS + 2


def _rank_main(spec_path, rank):
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    bootstrap.initialize(Config(
        dist_mode=1, num_processes=world, process_id=rank,
        coordinator_address="file://" + spec["store"]), device="cpu")
    data, model = spec["mesh"]
    for leg in spec["legs"]:
        _rank_leg(spec, leg, data, model, rank, spec["out"])
    bootstrap.barrier()
    bootstrap.destroy()


# ---------------------------------------------------------------------------
# The references and the runs
# ---------------------------------------------------------------------------

def _jax_fit(leg, mesh_model, weights=None):
    """The JAX Trainer (one device, or a 1 x mesh_model mesh) over the
    global batches: (flat params, eval result); ``weights`` False gives
    the initial flat params instead."""
    import jax  # noqa: PLC0415
    from deepfm_tpu.config import Config as JaxConfig  # noqa: PLC0415
    from deepfm_tpu.train import Trainer as JaxTrainer  # noqa: PLC0415
    from deepfm_tpu_torch.utils.params import (  # noqa: PLC0415
        flatten, params_from_jax)
    jt = JaxTrainer(JaxConfig(**_kw(**LEGS[leg], mesh_data=1,
                                    mesh_model=mesh_model)))
    js = jt.init_state()
    if weights is False:
        return params_from_jax(jax.tree.map(np.asarray, js.params),
                               jax.tree.map(np.asarray, js.model_state))
    hist = leg == "din"
    js, _ = jt.fit(js, iter(_batches(STEPS, seed=3, hist=hist)))
    ev = jt.evaluate(js, iter(_batches(2, seed=9, hist=hist)))
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, js.params)).items()}, ev


def _one_device(leg, weights_path):
    cfg = Config(**_kw(**LEGS[leg]))
    tr = Trainer(cfg, device="cpu")
    params, mstate = _weights(weights_path)
    state = tr.load_weights(tr.init_state(), params, mstate)
    hist = leg == "din"
    state, res = tr.fit(state, _batches(STEPS, seed=3, hist=hist))
    return tr, state, res


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    from test_torch_dp import run_ranks  # noqa: PLC0415
    root = tmp_path_factory.mktemp("mp")
    weights = {}
    for leg in LEGS:
        p, s = _jax_fit(leg, 1, weights=False)
        weights[leg] = str(root / f"{leg}.weights.npz")
        np.savez(weights[leg], **{f"p.{k}": v.numpy() for k, v in p.items()},
                 **{f"s.{k}": v.numpy() for k, v in s.items()})
    ckpt = {leg: str(root / f"ckpt_{leg}") for leg in CKPT_LEGS}
    out = {}
    for (data, model), legs in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"mp{data}x{model}")
        world = data * model
        run_ranks(world, {"mesh": [data, model], "legs": list(legs),
                          "weights": weights, "ckpt": ckpt}, tmp,
                  timeout=RANK_TIMEOUT_S, script=os.path.abspath(__file__))
        for leg in legs:
            tag = f"{leg}.{data}x{model}"
            ranks = []
            for r in range(world):
                with open(tmp / f"{tag}.{r}.json") as f:
                    ranks.append((dict(np.load(tmp / f"{tag}.{r}.npz")),
                                  json.load(f)))
            out[(leg, data, model)] = ranks
            if leg in CKPT_LEGS and (data, model) in ((1, 4), (2, 2)):
                out[("restored", leg, data, model)] = [
                    dict(np.load(tmp / f"restored.{tag}.{r}.npz"))
                    for r in range(world)]
    one = {leg: _one_device(leg, weights[leg]) for leg in LEGS}
    return {"runs": out, "one": one, "weights": weights, "ckpt": ckpt}


@pytest.fixture(scope="module")
def jax_ref():
    return {(leg, m): _jax_fit(leg, m) for leg in LEGS for m in (1, 2)
            if m == 1 or leg in JAX_MP2}


def _cases(filter_fn):
    return [(leg, d, m) for (d, m), legs in MESHES.items() for leg in legs
            if filter_fn(d, m)]


MODEL_ONLY = _cases(lambda d, m: d == 1)
ALL = _cases(lambda d, m: True)


def _ids(cases):
    return [f"{leg}-{d}x{m}" for leg, d, m in cases]


@pytest.mark.parametrize("leg,data,model", MODEL_ONLY, ids=_ids(MODEL_ONLY))
def test_model_axis_bit_equal_to_one_device(mp, leg, data, model):
    """A model-only mesh trains the tables (gathered), the other params,
    the optimizer state and the BN statistics bit for bit as the port's
    one-device run: each lookup and exchange element has one nonzero part,
    and each row's cotangents sum in the one-device order. Every rank's
    gathered state is the same, and holds 1/M of each table."""
    ranks = mp["runs"][(leg, data, model)]
    _, state, res = mp["one"][leg]
    want = _state_arrays(state)
    for arr, meta in ranks:
        assert meta["step"] == STEPS
        assert set(arr) - {"probs"} == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(arr[k], v, err_msg=k)
        for k, rows in meta["local_rows"].items():
            if k.startswith(("fm_w", "fm_v")):
                assert rows * model == state.params[k].shape[0], k
    assert ranks[0][1]["fit"]["loss"] == pytest.approx(res["loss"],
                                                       rel=1e-6)


def _hold_jax(arr, jparams, tol=None, init=None):
    """Params against the JAX ones. DIN's score bias ``att.b2`` is held as
    ``tests/test_torch_sequence.py`` holds it: the softmax is
    shift-invariant, so its gradient is float noise that Adam's normalized
    step turns into moves of either sign; both runs stay within Adam's
    largest move over the run (STEPS * lr) of ``init``."""
    for key, val in jparams.items():
        if key == "att.b2":
            bound = STEPS * _kw()["learning_rate"] * 1.001
            for moved in (arr[f"p.{key}"], val):
                assert np.all(np.abs(moved - init) <= bound)
            continue
        t = tol or (FM_B_TOL if key == "fm_b" else PARAM_TOL)
        np.testing.assert_allclose(arr[f"p.{key}"], val, err_msg=key, **t)


@pytest.mark.parametrize("leg,data,model", ALL, ids=_ids(ALL))
def test_mesh_matches_jax_single_device(mp, jax_ref, leg, data, model):
    """Every mesh against the JAX single-device Trainer on the global
    batches (the JAX sparse Trainer for the rows legs): params within rtol
    1e-3 / atol 1e-5 (fm_b rtol 5e-3 / atol 2e-4), eval loss within 1e-4,
    AUC within 5e-3."""
    jparams, jev = jax_ref[(leg, 1)]
    arr, meta = mp["runs"][(leg, data, model)][0]
    init = np.load(mp["weights"][leg]).get("p.att.b2")
    _hold_jax(arr, jparams, init=init)
    assert abs(meta["eval"]["loss"] - float(jev["loss"])) <= 1e-4
    assert abs(meta["eval"]["auc"] - float(jev["auc"])) <= 5e-3


@pytest.mark.parametrize("leg,data,model",
                         [c for c in MODEL_ONLY if c[0] in JAX_MP2],
                         ids=_ids([c for c in MODEL_ONLY if c[0] in JAX_MP2]))
def test_model_axis_matches_jax_1x2_trainer(mp, jax_ref, leg, data, model):
    """The model-only legs against the JAX 1x2 Trainer (its masked psum and
    row exchange under shard_map): rtol 1e-3 / atol 1e-5, as the JAX
    package's ``test_mp2_matches_single`` pins its own 1x2 run."""
    jparams, _ = jax_ref[(leg, 2)]
    arr, _ = mp["runs"][(leg, data, model)][0]
    _hold_jax(arr, jparams, tol=PARAM_TOL)


@pytest.mark.parametrize("leg", MESHES[(2, 2)])
def test_eval_and_predict_on_2x2_state_equal_one_device(mp, leg):
    """Evaluate and predict a 2x2-trained state on the mesh (each data rank
    its rows, the model peers summing their shards' lookups) against the
    same state, gathered, on one device over the global batches: the AUC
    equal (integer histograms), the loss within 1e-6, each data rank's
    probabilities equal to the one-device rows within 1e-6; the ranks of a
    mesh row agree bit for bit, and the ranks' gathered states too."""
    ranks = mp["runs"][(leg, 2, 2)]
    arr0, meta0 = ranks[0]
    for arr, meta in ranks[1:]:
        for k in arr0:
            if k != "probs":
                np.testing.assert_array_equal(arr[k], arr0[k], err_msg=k)
        for key in ("auc", "loss", "examples", "batches"):
            assert meta["eval"][key] == meta0["eval"][key], key
    cfg = Config(**_kw(**LEGS[leg]))
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()
    tr.load_weights(state, {k: torch.from_numpy(arr0[f"p.{k}"])
                            for k in state.params},
                    {k: torch.from_numpy(arr0[f"s.{k}"])
                     for k in state.model_state})
    ev = tr.evaluate(state, _batches(2, seed=9))
    probs = np.concatenate(list(tr.predict(state, _batches(2, seed=9))))
    assert meta0["eval"]["auc"] == ev["auc"]
    assert meta0["eval"]["examples"] == ev["examples"]
    assert abs(meta0["eval"]["loss"] - ev["loss"]) <= EVAL_LOSS_TOL
    local = B // 2
    for r, (arr, _) in enumerate(ranks):
        d = r // 2
        want = np.concatenate([probs[i * B + d * local:i * B + (d + 1)
                                     * local] for i in range(2)])
        np.testing.assert_allclose(arr["probs"], want, rtol=0,
                                   atol=PRED_TOL)


def _ckpt_arrays(path):
    mgr = ckpt_lib.CheckpointManager(path)
    d = torch.load(os.path.join(path, f"ckpt-{mgr.latest_step()}.pt"),
                   weights_only=True)
    arr = {f"p.{k}": v.numpy() for k, v in d["params"].items()}
    arr.update({f"s.{k}": v.numpy() for k, v in d["model_state"].items()})
    arr.update(_flat_opt(d["opt_state"]))
    return arr


@pytest.mark.parametrize("leg", CKPT_LEGS)
@pytest.mark.parametrize("mesh", [(1, 1), (1, 4), (2, 2)],
                         ids=["1x1", "1x4", "2x2"])
def test_checkpoint_1x2_restores_bit_exact(mp, leg, mesh):
    """A checkpoint saved at 1x2 holds the full tables and moments (the
    1x2 run's gathered state) and restores bit-exactly at 1x1, 1x4 and 2x2:
    params, model state and the optimizer's m/v/tau (or mu/nu); the
    restored state trains on (asserted in the rank processes)."""
    saved = _ckpt_arrays(mp["ckpt"][leg])
    trained, _ = mp["runs"][(leg, 1, 2)][0]
    for k, v in saved.items():
        np.testing.assert_array_equal(trained[k], v, err_msg=k)
    if mesh == (1, 1):
        tr = Trainer(Config(**_kw(**LEGS[leg])), device="cpu")
        got = [_state_arrays(ckpt_lib.CheckpointManager(mp["ckpt"][leg])
                             .restore(tr.init_state()))]
        one, _ = tr.fit(ckpt_lib.CheckpointManager(mp["ckpt"][leg]).restore(
            tr.init_state()), _batches(2, seed=5))
        assert all(np.isfinite(v.detach().numpy()).all()
                   for v in one.params.values())
    else:
        got = mp["runs"][("restored", leg) + mesh]
    for arr in got:
        assert set(arr) == set(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(arr[k], v, err_msg=k)


def test_rows_leg_reports_exchange_and_payload(mp):
    """A rows run reports its exchange's bytes per step (the JAX
    ``exchange_payload_bytes`` of every table and name) and, under a data
    axis, one gradient all_reduce per step of ``grad_payload_bytes``'s
    rows leg."""
    from deepfm_tpu.ops import embedding as jax_emb  # noqa: PLC0415
    fit = mp["runs"][("rows", 1, 2)][0][1]["fit"]
    n = B * 6
    want = (jax_emb.exchange_payload_bytes(n, 1, 2)
            + jax_emb.exchange_payload_bytes(n, 8, 2))
    assert fit["exchange_bytes"] == want
    assert "collective_applies" not in fit
    fit22 = mp["runs"][("rows", 2, 2)][0][1]["fit"]
    tr = Trainer(Config(**_kw(**LEGS["rows"])), device="cpu",
                 mesh_info=mesh_lib.MeshInfo(data_size=2, model_size=2))
    assert fit22["collective_applies"] == STEPS
    assert fit22["collective_bytes"] == STEPS * tr._grad_payload_bytes()
    assert fit22["exchange_bytes"] == jax_emb.exchange_payload_bytes(
        B // 2 * 6, 1, 2) + jax_emb.exchange_payload_bytes(B // 2 * 6, 8, 2)


# ---------------------------------------------------------------------------
# In-process: the mesh, the rules, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,data,model,ok", [
    (4, 0, 2, True), (4, 2, 2, True), (2, 0, 2, True), (4, 1, 4, True),
    (3, 0, 2, False), (4, 4, 2, False), (2, 2, 2, False)])
def test_build_mesh_coordinates(world, data, model, ok):
    """Rank r sits at (r // M, r % M) as the JAX package reshapes its
    devices [data, model]; a mesh that does not cover the processes raises
    naming ``--mesh_data`` / ``--mesh_model``."""
    cfg = Config(**_kw(mesh_data=data, mesh_model=model))
    if not ok:
        with pytest.raises(ValueError, match="--mesh_(data|model)") as e:
            mesh_lib.build_mesh(cfg, world=world)
        assert "queue 1" not in str(e.value)
        return
    info = mesh_lib.build_mesh(cfg, world=world)
    assert info.num_processes == world and info.model_size == model
    d = info.data_size
    assert [info.data_ranks(j) for j in range(model)] == [
        [i * model + j for i in range(d)] for j in range(model)]
    assert [info.model_ranks(i) for i in range(d)] == [
        [i * model + j for j in range(model)] for i in range(d)]


def test_trainer_rules_follow_the_data_axis():
    """The learning rate scales by the DATA size (the JAX package's
    ``world_size=data_size``), the row plane runs under any mesh with
    ``--embedding_shard rows``, and the sparse update under a mesh without
    it still warns and trains dense."""
    cfg = Config(**_kw(scale_lr_by_world=True))
    tr = Trainer(cfg, device="cpu",
                 mesh_info=mesh_lib.MeshInfo(data_size=2, model_size=2))
    assert tr.opt.lr == pytest.approx(2 * cfg.learning_rate)
    rows = Trainer(Config(**_kw(**LEGS["rows"])), device="cpu",
                   mesh_info=mesh_lib.MeshInfo(data_size=2, model_size=1))
    assert rows.sparse_embed and rows._row_plane and rows._shard is None
    dense = Trainer(Config(**_kw(embedding_update="sparse")), device="cpu",
                    mesh_info=mesh_lib.MeshInfo(data_size=2))
    assert not dense.sparse_embed


def _refusals():
    sparse_rows = dict(embedding_update="sparse", embedding_shard="rows")
    return [
        ("tiering", dict(sparse_rows, mesh_model=2,
                         embedding_tiering="hot_cold",
                         embedding_hot_rows=64, steps_per_loop=1),
         "embedding_tiering"),
        ("accum", dict(sparse_rows, mesh_model=2, grad_accum_steps=2,
                       steps_per_loop=4), "grad_accum_steps"),
        ("device_dataset", dict(sparse_rows, mesh_model=2,
                                device_dataset=True, decoded_cache="ram"),
         "device_dataset"),
        ("hashed_dense", dict(mesh_model=2, embedding_buckets="256,128"),
         "--embedding_shard rows"),
        ("buckets", dict(sparse_rows, mesh_model=2,
                         embedding_buckets="255,128"), "mesh_model=2"),
        ("sparse_no_rows", dict(embedding_update="sparse", mesh_model=2),
         "--embedding_shard rows"),
    ]


@pytest.mark.parametrize("name,kw,flag", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_refusals_name_their_flag_as_jax(name, kw, flag):
    """What stays refused under a model axis raises ``ValueError`` naming
    its flag, with the JAX package's message, never a queue item."""
    from deepfm_tpu.config import Config as JaxConfig  # noqa: PLC0415
    with pytest.raises(ValueError) as want:
        JaxConfig(**_kw(**kw))
    with pytest.raises(ValueError, match=flag) as got:
        Config(**_kw(**kw))
    assert str(got.value) == str(want.value)
    assert "queue 1" not in str(got.value)


def test_tier_and_device_dataset_refused_under_the_model_axis(tmp_path):
    """The hot/cold tier under a mesh raises naming it; the resident
    dataset is ineligible under a model axis (the staged path runs)."""
    tier = dict(embedding_update="sparse", embedding_tiering="hot_cold",
                embedding_hot_rows=64, steps_per_loop=1)
    with pytest.raises(ValueError, match="hot_cold requires the sparse"):
        Trainer(Config(**_kw(**tier)), device="cpu",
                mesh_info=mesh_lib.MeshInfo(data_size=2))
    tr = Trainer(Config(**_kw()), device="cpu",
                 mesh_info=mesh_lib.MeshInfo(model_size=2))
    assert "model-parallel mesh" in tr.device_dataset_ineligible(object())


def test_check_task_ported_checks_the_mesh_up_front():
    """Under ``--dist_mode 1`` the tasks check D x M against
    ``--num_processes`` before any process group starts."""
    ok = dict(dist_mode=1, num_processes=4, mesh_model=2)
    tasks.check_task_ported(Config(**_kw(**ok)))
    tasks.check_task_ported(Config(**_kw(**ok, mesh_data=2)))
    for bad in (dict(ok, num_processes=3), dict(ok, mesh_data=4)):
        with pytest.raises(ValueError, match="--mesh_"):
            tasks.check_task_ported(Config(**_kw(**bad)))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
