"""The port's retrieve→rank cascade (``rec.cascade``, with ``load_serving``'s
``raw_call`` and the publisher's ``extra_export``) on the CPU, class for
class as ``tests/test_cascade.py`` holds the JAX package's: the towers'
files both ways with the JAX package (``towers.npz`` leaf order is the
contract), the artifact, serving, the hot swap and the deferred swap, the
publisher hook, the fused path, a history-free ranker and
``_fit_history``.

Against the JAX package: a DIN ranker and a twin tower trained by the JAX
package, carried into the port (``params_from_jax``,
``tower_params_from_jax``); the port's staged ``recommend`` returns the
same items as JAX's staged ``recommend`` over the same weights, with
probabilities within 1e-6. The port's fused path is held against the
port's own staged path, bit for bit (not against the JAX package's fused
leg, which its own test fails).

Sizes: F = 5, K = 4, L = 6, B = 32, V = 120, DIN tower "8", float32.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.models import twin_tower as jax_tt
from deepfm_tpu.rec import cascade as jax_cascade
from deepfm_tpu.rec import index as jax_index
from deepfm_tpu.train import Trainer as JaxTrainer
from deepfm_tpu.utils import export as jax_export
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.models import get_model
from deepfm_tpu_torch.models import twin_tower as tt
from deepfm_tpu_torch.rec import cascade
from deepfm_tpu_torch.rec.cascade import (
    ITEM_SLOT, TOWERS_CONFIG_FILE, TOWERS_FILE, CascadeEngine, CascadeModel,
    _fit_history, cascade_extra_export, export_cascade, load_towers,
    save_towers)
from deepfm_tpu_torch.rec.index import (INDEX_FILE, INDEX_META_FILE,
                                        CandidateIndex)
from deepfm_tpu_torch.train.publish import Publisher
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils.params import (flatten, params_from_jax,
                                           tower_params_from_jax)

torch.set_num_threads(1)

FEATURE_SIZE = 120
FIELD_SIZE = 5
HIST_LEN = 6
BATCH = 32
N_BATCHES = 8
PROB_ATOL = 1e-6
# Eleven tables: JAX's tree_flatten sorts t10 before t2.
HASHED_11 = dict(embedding_buckets="7,11,13,17,19,23,29,31,37,41,43")


def _kw(**kw):
    base = dict(
        feature_size=FEATURE_SIZE, field_size=FIELD_SIZE, embedding_size=4,
        deep_layers="8", dropout="1.0", batch_size=BATCH,
        compute_dtype="float32", mesh_data=1, log_steps=0, seed=3,
        scale_lr_by_world=False, model="din", history_max_len=HIST_LEN)
    base.update(kw)
    return base


def _cfg(**kw):
    return Config(**_kw(**kw))


def _batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(N_BATCHES):
        lens = rng.integers(0, HIST_LEN + 1, BATCH)
        mask = (np.arange(HIST_LEN)[None, :] < lens[:, None]).astype(
            np.float32)
        out.append({
            "label": rng.integers(0, 2, (BATCH, 1)).astype(np.float32),
            "feat_ids": rng.integers(0, FEATURE_SIZE, (BATCH, FIELD_SIZE)
                                     ).astype(np.int32),
            "feat_vals": rng.normal(size=(BATCH, FIELD_SIZE)).astype(
                np.float32),
            "hist_ids": (rng.integers(1, FEATURE_SIZE, (BATCH, HIST_LEN))
                         * mask).astype(np.int32),
            "hist_mask": mask})
    return out


def _request(seed=0, hist_rows=4, hist_len=HIST_LEN):
    rng = np.random.default_rng(seed)
    hist_ids = rng.integers(1, FEATURE_SIZE, (hist_len,)).astype(np.int32)
    hist_mask = np.zeros((hist_len,), np.float32)
    hist_mask[:hist_rows] = 1.0
    feat_ids = rng.integers(0, FEATURE_SIZE, (FIELD_SIZE,)).astype(np.int32)
    feat_vals = rng.normal(size=(FIELD_SIZE,)).astype(np.float32)
    return hist_ids, hist_mask, feat_ids, feat_vals


def _engine(publish_dir, **kw):
    kw.setdefault("retrieve_k", 16)
    return CascadeEngine(publish_dir, max_batch=BATCH, max_delay_ms=1.0,
                         watcher_kw={"poll_secs": 3600, "start": False},
                         device="cpu", **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX package's DIN ranker and twin tower trained on the batches,
    and the port's modules carrying their weights."""
    batches = _batches()
    jcfg = JaxConfig(**_kw())
    jtower, jtower_params, _ = jax_tt.train_twin_tower(jcfg, batches,
                                                       item_slot=ITEM_SLOT)
    jtower_params = jax.tree.map(np.asarray, jtower_params)
    trainer = JaxTrainer(jcfg)
    state = trainer.init_state()
    step_fn = trainer._make_train_step()
    for b in batches:
        state, _ = step_fn(state, trainer.put_batch(b))
    tower = tt.TwinTower(_cfg(), device="cpu")
    tower.load_state_dict(tower_params_from_jax(jtower_params))
    ranker = get_model(_cfg(), device="cpu")
    p, s = params_from_jax(jax.tree.map(np.asarray, state.params),
                           jax.tree.map(np.asarray, state.model_state))
    ranker.load_state_dict({**p, **s})
    items = tower.all_item_embeddings(FEATURE_SIZE)
    users = tower.user_embed(torch.from_numpy(batches[0]["hist_ids"]),
                             torch.from_numpy(batches[0]["hist_mask"])
                             ).detach().numpy()
    return types.SimpleNamespace(
        batches=batches, jcfg=jcfg, jtower=jtower,
        jtower_params=jtower_params, jtrainer=trainer, jstate=state,
        tower=tower, ranker=ranker, items=items, users=users)


@pytest.fixture(scope="module")
def cascade_publish(tmp_path_factory, trained):
    """Publish dir with cascade version 1 live (the port's DIN ranker +
    towers + ANN index with a measured recall stamp)."""
    index = CandidateIndex(trained.items, kind="ann", seed=0, device="cpu")
    r50 = index.recall_at_k(trained.users, 50)
    publish_dir = str(tmp_path_factory.mktemp("cascade_pub"))
    export_cascade(trained.ranker, _cfg(), os.path.join(publish_dir, "1"),
                   tower=trained.tower, index=index,
                   index_meta={"recall_at_50": r50}, step=1)
    export_lib.write_latest(publish_dir, "1")
    return {"dir": publish_dir, "index": index, "recall_at_50": r50}


@pytest.fixture(scope="module")
def brute_publish(tmp_path_factory, trained):
    """A publish dir whose version 1 carries a BRUTE index (the fusable
    kind) over the same ranker and towers."""
    index = CandidateIndex(trained.items, kind="brute", device="cpu")
    publish_dir = str(tmp_path_factory.mktemp("cascade_pub_brute"))
    export_cascade(trained.ranker, _cfg(), os.path.join(publish_dir, "1"),
                   tower=trained.tower, index=index)
    export_lib.write_latest(publish_dir, "1")
    return publish_dir


@pytest.fixture(scope="module")
def jax_brute_publish(tmp_path_factory, trained):
    """The JAX package's cascade artifact of the same trained pieces."""
    index = jax_index.CandidateIndex(trained.jtower.all_item_embeddings(
        trained.jtower_params, FEATURE_SIZE), kind="brute")
    publish_dir = str(tmp_path_factory.mktemp("jax_cascade_pub"))
    orig = jax_export._export_tf_savedmodel
    jax_export._export_tf_savedmodel = lambda *a, **k: None
    try:
        jax_cascade.export_cascade(
            trained.jtrainer.model, trained.jstate, trained.jcfg,
            os.path.join(publish_dir, "1"),
            tower_params=trained.jtower_params, index=index)
    finally:
        jax_export._export_tf_savedmodel = orig
    jax_export.write_latest(publish_dir, "1")
    return publish_dir


# ---------------------------------------------------------------------------
# Towers' files: the JAX package's contract, both ways
# ---------------------------------------------------------------------------

class TestTowersFiles:
    def test_leaf_order_is_tree_flatten_order(self):
        names = ["user.1.w", "emb.t2", "item.0.w", "emb.t10", "user.0.b",
                 "item.0.b", "emb.t1", "user.10.b", "user.2.b"]
        assert cascade._leaf_order(names) == [
            "emb.t1", "emb.t10", "emb.t2", "item.0.b", "item.0.w",
            "user.0.b", "user.1.w", "user.2.b", "user.10.b"]

    @pytest.mark.parametrize("layout", [{}, HASHED_11],
                             ids=["mono", "hashed11"])
    def test_port_written_towers_load_in_jax(self, layout, tmp_path):
        tower = tt.TwinTower(_cfg(**layout), device="cpu")
        save_towers(tower, _cfg(**layout), str(tmp_path))
        jmodel, jparams = jax_cascade.load_towers(str(tmp_path))
        want = {k: v.numpy() for k, v in tower.state_dict().items()}
        got = {k: np.asarray(v) for k, v in flatten(
            jax.tree.map(np.asarray, jparams)).items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        ids = np.arange(16, dtype=np.int32)
        with torch.no_grad():
            mine = tower.item_embed(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(
            np.asarray(jmodel.item_embed(jparams, ids)), mine, rtol=0,
            atol=1e-6)

    @pytest.mark.parametrize("layout", [{}, HASHED_11],
                             ids=["mono", "hashed11"])
    def test_jax_written_towers_load_in_port(self, layout, tmp_path):
        jcfg = JaxConfig(**_kw(**layout))
        params = jax.tree.map(np.asarray, jax_tt.TwinTower(jcfg).init(
            jax.random.PRNGKey(5)))
        jax_cascade.save_towers(params, jcfg, str(tmp_path))
        tower = load_towers(str(tmp_path), device="cpu")
        assert not tower.training
        got = {k: v.numpy() for k, v in tower.state_dict().items()}
        want = flatten(params)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_towers_save_load_roundtrip(self, trained, tmp_path):
        save_towers(trained.tower, _cfg(), str(tmp_path))
        tower2 = load_towers(str(tmp_path), device="cpu")
        ids = torch.arange(16, dtype=torch.int32)
        with torch.no_grad():
            torch.testing.assert_close(tower2.item_embed(ids),
                                       trained.tower.item_embed(ids),
                                       rtol=0, atol=0)

    def test_leaf_count_mismatch_raises(self, tmp_path):
        save_towers(tt.TwinTower(_cfg(), device="cpu"), _cfg(**HASHED_11),
                    str(tmp_path))
        with pytest.raises(ValueError, match="leaves"):
            load_towers(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# The artifact
# ---------------------------------------------------------------------------

class TestCascadeArtifact:
    def test_marker_certifies_all_three_stages(self, cascade_publish):
        v1 = os.path.join(cascade_publish["dir"], "1")
        for name in (export_lib.COMPLETE_MARKER, TOWERS_FILE,
                     TOWERS_CONFIG_FILE, INDEX_FILE, INDEX_META_FILE,
                     "model_config.json"):
            assert os.path.exists(os.path.join(v1, name)), name

    def test_recall_stamp_in_artifact(self, cascade_publish):
        with open(os.path.join(cascade_publish["dir"], "1",
                               INDEX_META_FILE)) as f:
            meta = json.load(f)
        assert meta["kind"] == "ann"
        assert meta["recall_at_50"] == cascade_publish["recall_at_50"]
        assert meta["recall_at_50"] >= 0.95

    def test_signature_is_packed_columns(self, cascade_publish):
        with open(os.path.join(cascade_publish["dir"], "1",
                               "model_config.json")) as f:
            meta = json.load(f)
        assert meta["history_len"] == HIST_LEN
        assert meta["signature"]["inputs"]["feat_ids"][1] \
            == FIELD_SIZE + HIST_LEN

    def test_jax_loads_the_port_artifact_retrieval_stage(self,
                                                         cascade_publish):
        v1 = os.path.join(cascade_publish["dir"], "1")
        jidx, jmeta = jax_index.CandidateIndex.load(v1)
        assert jmeta["recall_at_50"] == cascade_publish["recall_at_50"]
        np.testing.assert_array_equal(jidx._q, cascade_publish["index"]._q)
        jax_cascade.load_towers(v1)


# ---------------------------------------------------------------------------
# load_serving's raw_call
# ---------------------------------------------------------------------------

class TestRawCall:
    @pytest.mark.parametrize("buckets", [None, (1, 4, 16, BATCH)])
    def test_raw_call_is_the_served_forward(self, brute_publish, buckets):
        fn = export_lib.load_serving(os.path.join(brute_publish, "1"),
                                     buckets=buckets, device="cpu")
        rng = np.random.default_rng(1)
        ids = rng.integers(0, FEATURE_SIZE, (16, FIELD_SIZE + HIST_LEN)
                           ).astype(np.int32)
        vals = rng.random((16, FIELD_SIZE + HIST_LEN), dtype=np.float32)
        logits = fn.raw_call(torch.from_numpy(ids), torch.from_numpy(vals))
        assert isinstance(logits, torch.Tensor) and logits.shape == (16,)
        np.testing.assert_array_equal(
            export_lib.host_sigmoid(logits.numpy()), fn(ids, vals))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine(cascade_publish):
    eng = _engine(cascade_publish["dir"], retrieve_k=20)
    try:
        yield eng
    finally:
        eng.close()


class TestCascadeServing:
    def test_recommend_end_to_end(self, engine):
        items, probs = engine.recommend(*_request(seed=1), k=10)
        assert items.shape == (10,) and probs.shape == (10,)
        assert items.dtype == np.int64
        assert len(set(map(int, items))) == 10          # distinct candidates
        assert np.all(np.isfinite(probs))
        assert np.all((probs >= 0) & (probs <= 1))
        assert np.all(np.diff(probs) <= 0)              # ranker-sorted

    def test_empty_history_finite_end_to_end(self, engine):
        _, _, feat_ids, feat_vals = _request(seed=2)
        items, probs = engine.recommend(
            np.zeros((HIST_LEN,), np.int32),
            np.zeros((HIST_LEN,), np.float32), feat_ids, feat_vals, k=5)
        assert np.all(np.isfinite(probs))
        assert np.all((probs >= 0) & (probs <= 1))

    def test_retrieve_stage_shapes(self, engine):
        hist_ids, hist_mask, _, _ = _request(seed=3)
        ids, scores = engine.retrieve(hist_ids, hist_mask, k=7)
        assert ids.shape == (1, 7) and scores.shape == (1, 7)

    def test_rank_consistent_with_direct_ranker(self, engine):
        hist_ids, hist_mask, feat_ids, feat_vals = _request(seed=4)
        items, probs = engine.recommend(
            hist_ids, hist_mask, feat_ids, feat_vals, k=3)
        model = engine.current()
        row_ids = feat_ids.copy()
        row_ids[ITEM_SLOT] = items[0]
        h_ids, h_mask = _fit_history(hist_ids, hist_mask, model.hist_len)
        direct = np.asarray(model(np.concatenate([row_ids, h_ids])[None],
                                  np.concatenate([feat_vals, h_mask])[None]
                                  )).reshape(-1)
        np.testing.assert_allclose(probs[0], direct[0], rtol=1e-5)

    def test_context_width_validated(self, engine):
        hist_ids, hist_mask, _, _ = _request()
        with pytest.raises(ValueError, match="context fields"):
            engine.recommend(hist_ids, hist_mask,
                             np.zeros((FIELD_SIZE + 1,), np.int32),
                             np.zeros((FIELD_SIZE + 1,), np.float32))

    @pytest.mark.parametrize("seed,hist_rows", [(1, 4), (2, 0), (3, 6),
                                                (4, 1)])
    def test_staged_matches_jax_staged(self, brute_publish,
                                       jax_brute_publish, seed, hist_rows):
        """Carried ranker and tower weights: the port's staged answer and
        the JAX package's name the same items, probabilities within
        1e-6."""
        req = _request(seed=seed, hist_rows=hist_rows)
        jeng = jax_cascade.CascadeEngine(
            jax_brute_publish, retrieve_k=16, max_batch=BATCH,
            max_delay_ms=1.0, watcher_kw={"poll_secs": 3600,
                                          "start": False})
        eng = _engine(brute_publish)
        try:
            j_items, j_probs = jeng.recommend(*req, k=8)
            p_items, p_probs = eng.recommend(*req, k=8)
            jr, _ = jeng.retrieve(req[0], req[1], k=16)
            pr, _ = eng.retrieve(req[0], req[1], k=16)
        finally:
            jeng.close()
            eng.close()
        np.testing.assert_array_equal(pr, jr)
        np.testing.assert_array_equal(p_items, j_items)
        np.testing.assert_allclose(p_probs, j_probs, rtol=0,
                                   atol=PROB_ATOL)

    def test_hot_swap_is_atomic_and_prewarmed(self, engine, cascade_publish,
                                              trained):
        """Publish version 2, drive one poll: ranker + towers + index all
        move in ONE swap, buckets prewarmed off-thread, zero failures,
        serving uninterrupted."""
        assert engine.watcher.swap_count == 1
        prewarmed_v1 = engine.watcher.prewarmed_buckets
        assert prewarmed_v1 > 0
        before = engine.current()
        export_cascade(
            trained.ranker, _cfg(), os.path.join(cascade_publish["dir"], "2"),
            tower=trained.tower, index=cascade_publish["index"],
            index_meta={"recall_at_50": cascade_publish["recall_at_50"]})
        export_lib.write_latest(cascade_publish["dir"], "2")
        assert engine.watcher.check_once()
        after = engine.current()
        assert engine.watcher.swap_count == 2
        assert engine.watcher.swap_failures == 0
        assert after is not before and after.path.endswith("2")
        assert after.index is not before.index
        assert after.tower is not before.tower
        assert after.rank_fn is not before.rank_fn
        assert engine.watcher.prewarmed_buckets > prewarmed_v1
        items, probs = engine.recommend(*_request(seed=5), k=10)
        assert np.all(np.isfinite(probs))
        assert engine.stats.summary()["serving_failed"] == 0

    def test_incomplete_artifact_defers_swap(self, engine, cascade_publish):
        """A marker-less version 3 must NOT swap in (and must not take the
        engine down): LATEST stays serviceable on the previous version."""
        v3 = os.path.join(cascade_publish["dir"], "3")
        os.makedirs(v3, exist_ok=True)           # torn artifact: no marker
        export_lib.write_latest(cascade_publish["dir"], "3")
        failures_before = engine.watcher.swap_failures
        current = engine.current().path
        try:
            assert not engine.watcher.check_once()
            assert engine.watcher.swap_failures == failures_before + 1
            assert engine.current().path == current
            _, probs = engine.recommend(*_request(seed=6), k=4)
            assert np.all(np.isfinite(probs))
        finally:
            export_lib.write_latest(cascade_publish["dir"],
                                    os.path.basename(current))
            engine.watcher.check_once()

    def test_engine_defaults_to_the_card(self, brute_publish, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CascadeEngine(brute_publish,
                          watcher_kw={"poll_secs": 3600, "start": False})


class TestPublisherIntegration:
    def _state(self, ranker):
        return types.SimpleNamespace(
            params=dict(ranker.named_parameters()),
            model_state=dict(ranker.named_buffers()))

    def test_extra_export_hook_ships_retrieval_stage(self, trained,
                                                     cascade_publish,
                                                     tmp_path):
        """``cascade_extra_export`` stamps towers + index into the staging
        dir BEFORE the marker lands, so the one marker certifies the whole
        cascade."""
        pdir = str(tmp_path / "pub")
        publisher = Publisher(
            _cfg(), pdir, extra_export=cascade_extra_export(
                _cfg(), trained.tower, cascade_publish["index"],
                index_meta={"recall_at_50": cascade_publish["recall_at_50"]}))
        publisher.publish_now(self._state(trained.ranker), 7)
        assert publisher.drain(timeout=120)
        publisher.close()
        assert publisher.published == [7]
        v7 = os.path.join(pdir, "7")
        for name in (export_lib.COMPLETE_MARKER, TOWERS_FILE, INDEX_FILE,
                     INDEX_META_FILE):
            assert os.path.exists(os.path.join(v7, name)), name
        assert export_lib.read_latest(pdir) == v7
        eng = _engine(pdir, retrieve_k=8)
        try:
            rng = np.random.default_rng(9)
            items, probs = eng.recommend(
                rng.integers(1, FEATURE_SIZE, (HIST_LEN,)).astype(np.int32),
                np.ones((HIST_LEN,), np.float32),
                rng.integers(0, FEATURE_SIZE,
                             (FIELD_SIZE,)).astype(np.int32),
                rng.normal(size=(FIELD_SIZE,)).astype(np.float32), k=4)
            assert np.all(np.isfinite(probs))
        finally:
            eng.close()

    def test_failing_hook_publishes_nothing(self, trained, tmp_path):
        pdir = str(tmp_path / "pub")

        def hook(staging):
            raise OSError("disk full")

        publisher = Publisher(_cfg(), pdir, extra_export=hook)
        publisher.publish_now(self._state(trained.ranker), 3)
        publisher.drain(timeout=120)
        publisher.close()
        assert publisher.published == [] and publisher.publish_failures == 1
        assert export_lib.read_latest(pdir) is None
        assert not os.path.exists(os.path.join(pdir, "3"))


# ---------------------------------------------------------------------------
# The fused device program
# ---------------------------------------------------------------------------

class TestFusedCascade:
    @pytest.fixture()
    def engines(self, brute_publish):
        staged = _engine(brute_publish)
        fused = _engine(brute_publish, fused=True)
        try:
            yield staged, fused
        finally:
            staged.close()
            fused.close()

    def test_artifact_exposes_raw_call(self, engines):
        _, fused = engines
        model = fused.current()
        assert getattr(model.rank_fn, "raw_call", None) is not None
        assert model.supports_fused and model.outputs == ("prob",)

    @pytest.mark.parametrize("seed,hist_rows,hist_len",
                             [(1, 4, HIST_LEN), (2, 0, HIST_LEN),
                              (3, 6, HIST_LEN), (4, 2, HIST_LEN + 3),
                              (5, 3, HIST_LEN - 2), (6, 0, 1)])
    def test_fused_matches_staged_bit_identical(self, engines, seed,
                                                hist_rows, hist_len):
        """The fused program returns the SAME items with BIT-IDENTICAL
        probabilities as the staged user_embed -> search -> substitute ->
        rank -> argsort path, empty, truncated and short histories
        included."""
        staged, fused = engines
        req = _request(seed=seed, hist_rows=hist_rows, hist_len=hist_len)
        s_items, s_probs = staged.recommend(*req, k=8)
        f_items, f_probs = fused.recommend(*req, k=8)
        assert f_items.dtype == s_items.dtype == np.int64
        np.testing.assert_array_equal(f_items, s_items)
        np.testing.assert_array_equal(f_probs, s_probs)
        assert fused.fused_calls == 1 and staged.fused_calls == 0
        assert fused.current().fused_failed is False

    def test_fused_empty_history_finite(self, engines):
        _, fused = engines
        _, _, feat_ids, feat_vals = _request(seed=7)
        items, probs = fused.recommend(
            np.zeros((HIST_LEN,), np.int32),
            np.zeros((HIST_LEN,), np.float32), feat_ids, feat_vals, k=5)
        assert np.all(np.isfinite(probs))
        assert np.all((probs >= 0) & (probs <= 1))

    def test_recommend_batch_matches_per_row(self, engines):
        staged, fused = engines
        reqs = [_request(seed=s) for s in (11, 12, 13)]
        cols = [np.stack([r[i] for r in reqs]) for i in range(4)]
        b_items, b_probs = fused.recommend_batch(*cols, k=6)
        assert b_items.shape == (3, 6) and b_probs.shape == (3, 6)
        for i, req in enumerate(reqs):
            items, probs = staged.recommend(*req, k=6)
            np.testing.assert_array_equal(b_items[i], items)
            np.testing.assert_allclose(b_probs[i], probs, rtol=1e-5)

    def test_fused_program_cache_is_bucketed(self, engines):
        """Batches 3 and 4 share bucket 4's program."""
        _, fused = engines
        model = fused.current()
        before = len(model._fused_cache)
        reqs = [_request(seed=s) for s in (21, 22, 23, 24)]
        cols = [np.stack([r[i] for r in reqs]) for i in range(4)]
        fused.recommend_batch(*[c[:3] for c in cols], k=4)
        n_after_3 = len(model._fused_cache)
        fused.recommend_batch(*cols, k=4)
        assert len(model._fused_cache) == n_after_3 == before + 1

    def test_failure_inside_fused_program_raises(self, engines,
                                                 monkeypatch):
        """No fallback: a failing stage raises to the caller and the model
        stays on the fused path."""
        _, fused = engines
        model = fused.current()

        def broken(ids, vals):
            raise RuntimeError("ranker failed")

        monkeypatch.setattr(model.rank_fn, "raw_call", broken)
        with pytest.raises(RuntimeError, match="ranker failed"):
            fused.recommend(*_request(seed=8), k=4)
        assert model.supports_fused and model.fused_failed is False

    def test_ann_index_gates_to_staged(self, cascade_publish):
        """fused=True over an ANN artifact serves via the staged path (the
        host-side partition scan is no device program): no error, no fused
        call."""
        eng = _engine(cascade_publish["dir"], retrieve_k=8, fused=True)
        try:
            assert not eng.current().supports_fused
            items, probs = eng.recommend(*_request(seed=31), k=4)
            assert np.all(np.isfinite(probs))
            assert eng.fused_calls == 0
            with pytest.raises(ValueError, match="serve it staged"):
                eng.current().fused_program(1, HIST_LEN, 8, 4)
        finally:
            eng.close()

    def test_multitask_artifact_is_refused_up_front(self, trained,
                                                    tmp_path):
        """A two-output ranker cannot fuse; supports_fused reads that from
        model_config.json before any work."""
        cfg = _cfg(model="deepfm", history_max_len=0, tasks="ctr,cvr",
                   multitask="shared_bottom")
        index = CandidateIndex(trained.items, device="cpu")
        export_cascade(get_model(cfg, device="cpu"), cfg,
                       str(tmp_path / "1"), tower=trained.tower, index=index)
        model = CascadeModel(str(tmp_path / "1"), buckets=(1, 8),
                             device="cpu")
        assert model.outputs == ("ctr", "cvr")
        assert model.rank_fn.raw_call is not None
        assert not model.supports_fused
        with pytest.raises(ValueError, match="one output"):
            model.fused_program(1, HIST_LEN, 8, 4)


class TestNoHistoryCascade:
    def test_history_free_artifact_serves_end_to_end(self, trained,
                                                     tmp_path):
        """A ranker exported WITHOUT history columns (hist_len == 0) serves
        the full cascade on the staged and fused paths, the same answer."""
        cfg = _cfg(model="deepfm", history_max_len=0)
        index = CandidateIndex(trained.items, kind="brute", device="cpu")
        publish_dir = str(tmp_path)
        export_cascade(get_model(cfg, device="cpu"), cfg,
                       os.path.join(publish_dir, "1"), tower=trained.tower,
                       index=index)
        export_lib.write_latest(publish_dir, "1")
        req = _request(seed=5, hist_rows=HIST_LEN)
        answers = []
        for fused in (False, True):
            eng = _engine(publish_dir, retrieve_k=8, fused=fused)
            try:
                assert eng.current().hist_len == 0
                items, probs = eng.recommend(*req, k=4)
                assert items.shape == (4,) and probs.shape == (4,)
                assert np.all(np.isfinite(probs))
                assert eng.fused_calls == int(fused)
                answers.append((items, probs))
            finally:
                eng.close()
        for a, b in zip(*answers):
            np.testing.assert_array_equal(a, b)


class TestFitHistory:
    def test_zero_hist_len_short_circuits(self):
        ids, mask = _fit_history(np.array([3, 4], np.int32),
                                 np.array([1, 1], np.float32), 0)
        assert ids.shape == (0,) and mask.shape == (0,)
        assert ids.dtype == np.int32 and mask.dtype == np.float32

    def test_pad_short_history(self):
        ids, mask = _fit_history(np.array([3, 4], np.int32),
                                 np.array([1, 1], np.float32), 5)
        np.testing.assert_array_equal(ids, [3, 4, 0, 0, 0])
        np.testing.assert_array_equal(mask, [1, 1, 0, 0, 0])

    def test_truncate_keeps_recent_tail(self):
        ids, mask = _fit_history(
            np.arange(1, 7, dtype=np.int32), np.ones((6,), np.float32), 4)
        np.testing.assert_array_equal(ids, [3, 4, 5, 6])
        np.testing.assert_array_equal(mask, [1, 1, 1, 1])

    def test_exact_length_passthrough(self):
        src = np.array([9, 8, 7], np.int32)
        ids, mask = _fit_history(src, np.ones((3,), np.float32), 3)
        np.testing.assert_array_equal(ids, src)

    @pytest.mark.parametrize("ln,hist_len", [(2, 5), (6, 4), (3, 3), (0, 2)])
    def test_equals_jax(self, ln, hist_len):
        rng = np.random.default_rng(ln * 7 + hist_len)
        ids = rng.integers(0, 50, ln).astype(np.int32)
        mask = rng.random(ln).astype(np.float32)
        for a, b in zip(_fit_history(ids, mask, hist_len),
                        jax_cascade._fit_history(ids, mask, hist_len)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
