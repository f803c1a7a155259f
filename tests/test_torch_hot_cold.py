"""The port's hot/cold embedding tier (``deepfm_tpu_torch.data.hot_cold``)
and its cache install (``embedding_kernels.install_rows``) against the JAX
package's, on the CPU.

Sizes follow ``tests/test_hot_cold.py`` (V=500, B=32, F=6, K=8, 256 hot
rows, 12 batches). The cold store is host numpy on both sides, so its
bytes, scales and rows are compared bit for bit (fp8 through torch's
``float8_e4m3fn`` cast against ``ml_dtypes``). The install is a copy, so
every leg is compared bit for bit with the JAX ones. The tiered Trainer is
held to three things: the JAX runtime's directory and stats at
``transfer_ahead=0`` with tables in the sparse trajectory bands (the float32
sum order of the tower and FM between XLA and PyTorch, as in
``tests/test_torch_sparse.py``); the port's own untiered sparse run bit for
bit at depths 0 and 2 (the tier moves rows, never their values); and its
checkpoints, which restore into either layout bit-exactly.
"""

import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.data import hot_cold as jhc
from deepfm_tpu.ops import pallas_embedding as pemb
from deepfm_tpu.train import Trainer as JaxTrainer
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import hot_cold as hc
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.ops import embedding_kernels as ek
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils import faults
from deepfm_tpu_torch.utils.params import (flatten, opt_state_from_jax,
                                           params_from_jax)

torch.set_num_threads(1)

V, B, F, K, NB, HOT = 500, 32, 6, 8, 12, 256
TIER = dict(embedding_tiering="hot_cold", embedding_hot_rows=HOT)
# The sparse trajectory bands of tests/test_torch_sparse.py (same lr and
# l2, fewer steps).
LOSS_ATOL, PARAM_ATOL, M_ATOL, V_RTOL = 1e-6, 2e-6, 1e-7, 1e-5
COUNTED = ("lookups", "hits", "misses", "evictions", "installs", "plans",
           "fetch_retries")
ARGS = ("w", "m", "v", "tau", "slots", "wv", "mv", "vv", "tv")
EMB = ("fm_w", "fm_v")


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="1.0,1.0", batch_size=B,
                compute_dtype="float32", l2_reg=1e-3, learning_rate=5e-4,
                log_steps=0, seed=11, scale_lr_by_world=False, mesh_data=1,
                mesh_model=1, steps_per_loop=1, embedding_update="sparse")
    base.update(kw)
    return base


def _batches(nb=NB, seed=3):
    rng = np.random.default_rng(seed)
    return [{"feat_ids": rng.integers(0, V, (B, F)).astype(np.int32),
             "feat_vals": rng.standard_normal((B, F)).astype(np.float32),
             "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}
            for _ in range(nb)]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(np.int32)


def _assert_bits(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _snapshot(state):
    """A CPU copy of params and lazy-Adam slots (states update in place)."""
    out = {k: v.detach().clone() for k, v in state.params.items()}
    for name, tabs in state.opt_state["embed"].items():
        for key, e in tabs.items():
            for f in e._fields:
                out[f"opt.{name}.{key}.{f}"] = getattr(e, f).clone()
    return out


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _fit(cfg_kw, batches, state=None, trainer=None, **fit_kw):
    tr = trainer or Trainer(Config(**cfg_kw), device="cpu")
    st = tr.init_state() if state is None else state
    losses = []
    st, _ = tr.fit(st, batches, hooks=[
        lambda s, m: losses.append(float(m["loss"]))], **fit_kw)
    return tr, st, np.array(losses)


@pytest.fixture(scope="module")
def untiered():
    """The port's untiered sparse run: the bit-exactness reference."""
    _, st, losses = _fit(_kw(), _batches())
    return _snapshot(st), losses


# ---------------------------------------------------------------------------
# Cold store
# ---------------------------------------------------------------------------

def _table(shape, seed):
    """Rows over six decades, one all-zero row and one outlier row: int8
    rounding ties, fp8 subnormals and the scale floor all occur."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    a *= (10.0 ** rng.uniform(-4, 2, shape)).astype(np.float32)
    a[3] = 0.0
    a[5] *= 1e4
    return a


@pytest.mark.parametrize("dtype", ["float32", "int8", "fp8_e4m3"])
def test_cold_store_matches_jax_bit_for_bit(dtype):
    for i, shape in enumerate(((64, 8), (64,))):
        a = _table(shape, i)
        j, t = jhc.ColdStore(a, dtype), hc.ColdStore(a, dtype)
        assert t.nbytes() == j.nbytes()
        if dtype != "float32":
            _assert_bits(t._q, np.asarray(j._q).view(np.uint8) if dtype ==
                         "fp8_e4m3" else j._q, "quantized bytes")
            _assert_bits(t._scale, j._scale, "scales")
        rng = np.random.default_rng(10 + i)
        ids = rng.permutation(64)[:23]
        _assert_bits(t.fetch(ids), j.fetch(ids), "fetch")
        new = _table((9,) + shape[1:], 20 + i)
        j.write(ids[:9], new)
        t.write(ids[:9], new)
        _assert_bits(t.fetch(ids), j.fetch(ids), "fetch after write")
        _assert_bits(t.dense(), j.dense(), "dense")
        if dtype != "float32":
            _assert_bits(t._scale, j._scale, "scales after write")


def test_cold_store_reuses_its_scratch():
    """fetch/write work out of per-store scratch: fetch returns a view of
    one buffer, which grows only to the next power of two."""
    a = _table((64, 8), 4)
    for dt in ("float32", "int8", "fp8_e4m3"):
        cs = hc.ColdStore(a, dt)
        base = cs.fetch(np.arange(4, 12)).base
        assert base is not None, dt
        assert cs.fetch(np.arange(8)).base is base, dt
        assert cs.fetch(np.arange(3)).base is base, dt
        cs.write(np.arange(5), a[:5])
        if dt != "float32":
            w = cs._write_f32
            cs.write(np.arange(2, 7), a[2:7])
            assert cs._write_f32 is w, dt
    cs = hc.ColdStore(a, "float32")
    cs.fetch(np.arange(5))
    assert cs._fetch_f32.shape[0] == 8
    cs.fetch(np.arange(20))
    assert cs._fetch_f32.shape[0] == 32
    with pytest.raises(ValueError, match="cold dtype"):
        hc.ColdStore(a, "int4")


# ---------------------------------------------------------------------------
# Cache install
# ---------------------------------------------------------------------------

def _install_case(d, h=16, n=5, p=8, seed=7):
    """One transaction as the runtime stages it: n distinct real slots, then
    pow-2 padding at the out-of-range slot h (one at h + 3). The padding
    carries values, so a dropped slot that was written would show."""
    rng = np.random.default_rng(seed + d)
    t_shape = (h,) if d == 1 else (h, d)
    v_shape = (p,) if d == 1 else (p, d)
    slots = np.full((p,), h, np.int32)
    slots[:n] = rng.choice(h, n, replace=False)
    slots[n + 1] = h + 3
    real = slots[(slots >= 0) & (slots < h)]
    assert np.unique(real).size == real.size == n  # distinct, as planned
    f = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(t_shape), "m": f(t_shape), "v": np.abs(f(t_shape)),
            "tau": rng.integers(0, 9, h).astype(np.int32), "slots": slots,
            "wv": f(v_shape), "mv": f(v_shape), "vv": np.abs(f(v_shape)),
            "tv": rng.integers(10, 20, p).astype(np.int32)}


def _jax_installs(host):
    j = {k: jnp.asarray(v) for k, v in host.items()}
    seed = [jhc._jit_install(j[t], j["slots"], j[x])
            for t, x in zip(ARGS[:4], ARGS[5:])]
    fused = pemb._install_fused_xla(*(j[k] for k in ARGS))
    for a, b in zip(seed, fused):
        _assert_bits(np.asarray(a), np.asarray(b))
    return [np.asarray(a) for a in seed]


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("leg", ["reference", "auto", "pallas", "xla", "off"])
def test_install_legs_match_the_jax_installs(d, leg):
    """reference_install and every install_rows leg, in place, bit-equal to
    ``_jit_install`` x4 and ``_install_fused_xla`` (D = 1 is the 1-D
    fm_w)."""
    host = _install_case(d)
    want = _jax_installs(host)
    got = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    before = ek.install_launches
    if leg == "reference":
        ek.reference_install(*(got[k] for k in ARGS))
    else:
        ek.install_rows(*(got[k] for k in ARGS), mode=leg)
    assert ek.install_launches == before  # CPU tensors launch nothing
    for key, w in zip(ARGS[:4], want):
        _assert_bits(got[key].numpy(), w, key)


@pytest.mark.pallas
def test_install_plain_version_matches_pallas_kernel():
    """At D = 8 against the Pallas kernel in the interpreter. (The TPU
    kernel indexes ``out[slot, :]`` and so cannot take the 1-D fm_w.)"""
    host = _install_case(8)
    want = pemb.install_pallas(*(jnp.asarray(host[k]) for k in ARGS),
                               interpret=True)
    got = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    ek.reference_install(*(got[k] for k in ARGS))
    for key, w in zip(ARGS[:4], want):
        _assert_bits(got[key].numpy(), np.asarray(w), key)


def test_install_resolve_and_input_checks():
    assert ek.resolve("auto", "install") == "kernel"
    assert ek.resolve("pallas", "install") == "kernel"
    assert ek.resolve("xla", "install") == "opt"
    assert ek.resolve("off", "install") == "ref"
    t = {k: torch.from_numpy(v) for k, v in _install_case(4).items()}
    ek._check_install(*(t[k] for k in ARGS))
    bad = dict(t, wv=t["wv"].double())
    with pytest.raises(TypeError, match="float32"):
        ek._check_install(*(bad[k] for k in ARGS))
    bad = dict(t, tv=t["tv"][:3])
    with pytest.raises(ValueError, match="install expects"):
        ek._check_install(*(bad[k] for k in ARGS))
    bad = dict(t, w=t["w"].t())
    with pytest.raises(ValueError, match="install expects"):
        ek._check_install(*(bad[k] for k in ARGS))


def test_pad_slots_is_a_pow2_ladder():
    rt = hc.TieredEmbeddingRuntime(Config(**_kw(**TIER)),
                                   Trainer(Config(**_kw(**TIER)),
                                           device="cpu").model)
    for n, p in ((0, 1), (1, 1), (3, 4), (4, 4), (5, 8), (200, 256)):
        ps = rt._pad_slots(np.arange(n, dtype=np.int32))
        assert ps.size == p == hc._pow2_pad(max(n, 1)) == jhc._pow2_pad(
            max(n, 1))
        assert np.all(ps[n:] == HOT) and np.array_equal(ps[:n], np.arange(n))


# ---------------------------------------------------------------------------
# The tiered Trainer against the JAX one
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_from_jax(cfg_kw, jstate, trainer=None):
    """A port trainer and the JAX dense ``jstate`` carried over (params,
    BN state, sparse optimizer state, step), adopted into the tier."""
    tt = trainer or Trainer(Config(**cfg_kw), device="cpu")
    ts = tt.load_weights(tt.init_state(tiered=False), *params_from_jax(
        _np(jstate.params), _np(jstate.model_state)))
    ts.opt_state = opt_state_from_jax(_np(jstate.opt_state))
    ts.step = int(jstate.step)
    return tt, tt._tier.adopt(ts)


def _assert_ckpt_matches_jax(jck, tck):
    want = {k: np.asarray(v) for k, v in flatten(_np(jck.params)).items()}
    for k, v in tck.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    for name in EMB:
        je = jck.opt_state["embed"][name]["table"]
        te = tck.opt_state["embed"][name]["table"]
        np.testing.assert_array_equal(te.tau.numpy(), np.asarray(je.tau))
        np.testing.assert_allclose(te.m.numpy(), np.asarray(je.m), rtol=0,
                                   atol=M_ATOL)
        v = np.asarray(je.v)
        np.testing.assert_allclose(te.v.numpy(), v, rtol=0,
                                   atol=V_RTOL * np.abs(v).max())
    assert tck.opt_state["count"] == int(jck.opt_state["count"])


def test_tiered_fit_matches_jax_directory_stats_and_tables():
    """transfer_ahead=0 (the JAX victims then do not depend on thread
    timing): the same directory, the same counted stats, tau exact, hot
    tables and the densified checkpoint state within the sparse bands."""
    cfg = _kw(transfer_ahead=0, **TIER)
    jt = JaxTrainer(JaxConfig(**cfg))
    jdense = jt.init_state(tiered=False)
    tt, ts = _port_from_jax(cfg, jdense)
    js = jt._tier.adopt(jdense)
    batches = _batches()
    js, _ = jt.fit(js, batches)
    ts, _ = tt.fit(ts, batches)
    jr, tr = jt._tier, tt._tier
    np.testing.assert_array_equal(tr.id_to_slot, jr.id_to_slot)
    np.testing.assert_array_equal(tr.slot_to_id, jr.slot_to_id)
    np.testing.assert_array_equal(tr.last_used, jr.last_used)
    assert {k: tr.stats[k] for k in COUNTED} == {
        k: jr.stats[k] for k in COUNTED}
    assert tr.stats["evictions"] > 0 and 0.0 < tr.hit_rate() < 1.0
    for name in EMB:
        np.testing.assert_allclose(ts.params[name].detach().numpy(),
                                   np.asarray(js.params[name]), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_array_equal(
            ts.opt_state["embed"][name]["table"].tau.numpy(),
            np.asarray(js.opt_state["embed"][name]["table"].tau))
    _assert_ckpt_matches_jax(jr.checkpoint_state(js), tr.checkpoint_state(ts))


def test_jax_tiered_checkpoint_carried_into_port_continues_jax_trajectory():
    """Six JAX tiered steps, the JAX ``checkpoint_state`` carried into a
    port tier and adopted (an empty hot cache: the directories differ from
    here on), six more steps on both sides agree as the trajectory does."""
    cfg = _kw(transfer_ahead=0, **TIER)
    jt = JaxTrainer(JaxConfig(**cfg))
    js = jt.init_state()
    batches = _batches(12, seed=5)
    js, _ = jt.fit(js, batches[:6])
    tt, ts = _port_from_jax(cfg, jt._tier.checkpoint_state(js))
    assert ts.opt_state["count"] == 6 and ts.step == 6
    js, _ = jt.fit(js, batches[6:])
    ts, _ = tt.fit(ts, batches[6:])
    _assert_ckpt_matches_jax(jt._tier.checkpoint_state(js),
                             tt._tier.checkpoint_state(ts))


# ---------------------------------------------------------------------------
# The tier against the port's untiered run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,switch_s", [(0, None), (2, None),
                                            (2, 1e-6)])
def test_tiered_densified_bit_identical_to_untiered(untiered, depth,
                                                    switch_s):
    """Float32 cold store: the densified tables and the full-shape Adam
    slots equal the untiered run's bit for bit, at depth 0 and with the
    staging thread two groups ahead (late fetches and pin waits), also with
    the interpreter switching threads every microsecond, so a lost update
    between the staging and fit threads would show. The loss sums the
    touched rows' l2 over the hot table's row order: 1e-7."""
    want, want_losses = untiered
    old_switch = sys.getswitchinterval()
    try:
        if switch_s is not None:
            sys.setswitchinterval(switch_s)
        tr, st, losses = _fit(_kw(transfer_ahead=depth, **TIER), _batches())
    finally:
        sys.setswitchinterval(old_switch)
    tier = tr._tier
    assert tier.stats["plans"] == NB
    assert tier.stats["evictions"] > 0, "HOT too large: nothing evicted"
    assert tier.stats["installs"] >= tier.stats["evictions"]
    assert 0.0 < tier.hit_rate() < 1.0
    assert st.params["fm_v"].shape[0] == HOT
    got = _snapshot(tier.checkpoint_state(st))
    _assert_same(got, want)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-7)
    assert not tier._pending and int(tier.pin_count.sum()) == 0


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_quantized_cold_tier_within_tolerance(untiered, dtype):
    want, _ = untiered
    tr, st, _ = _fit(_kw(transfer_ahead=2, embedding_cold_dtype=dtype,
                         **TIER), _batches())
    dense = tr._tier.densified(st)
    for name in EMB:
        d = float((dense.params[name] - want[name]).abs().max())
        assert d < 5e-2, (name, d)


@pytest.mark.faults
def test_cold_fetch_faults_heal_bit_exact(untiered):
    want, _ = untiered
    faults.set_cold_fetch_plan(2)
    try:
        tr, st, _ = _fit(_kw(transfer_ahead=2, **TIER), _batches())
    finally:
        faults.set_cold_fetch_plan(0)
    assert tr._tier.stats["fetch_retries"] == 2
    _assert_same(_snapshot(tr._tier.checkpoint_state(st)), want)


@pytest.mark.parametrize("depth", [0, 2])
def test_too_small_cache_raises(depth):
    tr = Trainer(Config(**_kw(transfer_ahead=depth, embedding_tiering=
                              "hot_cold", embedding_hot_rows=16)),
                 device="cpu")
    with pytest.raises(RuntimeError, match="hot cache too small"):
        tr.fit(tr.init_state(), _batches(2))
    assert not tr._tier._pending


class _Stop(Exception):
    pass


def _staging_threads():
    return {t for t in threading.enumerate()
            if t.name == "pipeline-prefetch" and t.is_alive()}


def test_abandoned_fit_stops_staging_and_resumes_exactly(untiered):
    """A fit abandoned after 3 dispatches with plans queued 2 ahead: its
    staging thread ends, the queued plans are applied (no pin held), and a
    second fit over the remaining batches ends bit-equal to one run."""
    want, _ = untiered
    batches = _batches()
    tr = Trainer(Config(**_kw(transfer_ahead=2, **TIER)), device="cpu")
    st = tr.init_state()
    before = _staging_threads()

    def stop_at_3(s, m):
        if s.step == 3:
            raise _Stop

    with pytest.raises(_Stop):
        tr.fit(st, batches, hooks=[stop_at_3])
    tier = tr._tier
    assert tier.stats["plans"] > 3
    assert not tier._pending and int(tier.pin_count.sum()) == 0
    deadline = time.time() + 10
    while _staging_threads() - before and time.time() < deadline:
        time.sleep(0.01)
    assert not _staging_threads() - before
    st, _ = tr.fit(st, batches[3:])
    _assert_same(_snapshot(tier.checkpoint_state(st)), want)


def test_checkpoint_state_mid_fit_with_plans_queued(untiered):
    """``checkpoint_state`` from a hook in the middle of a depth-2 fit (as
    the train task's ``save_checkpoints_steps`` hook takes it), while plans
    for later groups have already remapped the directory: it equals the
    untiered state after the same steps, and the fit then ends bit-equal
    to the untiered run."""
    want, _ = untiered
    batches = _batches()
    _, part, _ = _fit(_kw(), batches[:5])
    want_part = _snapshot(part)
    tr = Trainer(Config(**_kw(transfer_ahead=2, **TIER)), device="cpu")
    tier = tr._tier
    seen = {}

    def ckpt_at_5(s, m):
        if s.step == 5:
            seen["queued"] = len(tier._pending)
            seen["state"] = _snapshot(tier.checkpoint_state(s))

    st, _ = tr.fit(tr.init_state(), batches, hooks=[ckpt_at_5])
    assert seen["queued"] > 0
    _assert_same(seen["state"], want_part)
    _assert_same(_snapshot(tier.checkpoint_state(st)), want)


def test_tiered_checkpoint_restores_into_untiered_and_back(tmp_path):
    """Six steps in one layout, a checkpoint, six more in the other: both
    directions end bit-equal to twelve untiered steps."""
    batches = _batches(12, seed=8)
    _, full, _ = _fit(_kw(), batches)
    want = _snapshot(full)

    tt, ts, _ = _fit(_kw(transfer_ahead=2, **TIER), batches[:6])
    a = ckpt_lib.CheckpointManager(str(tmp_path / "tiered"))
    a.save(ts.step, tt._tier.checkpoint_state(ts))
    ut = Trainer(Config(**_kw()), device="cpu")
    _, us, _ = _fit(_kw(), batches[6:], trainer=ut,
                    state=a.restore(ut.init_state(seed=99)))
    _assert_same(_snapshot(us), want)

    _, us, _ = _fit(_kw(), batches[:6])
    b = ckpt_lib.CheckpointManager(str(tmp_path / "untiered"))
    b.save(us.step, us)
    tt = Trainer(Config(**_kw(transfer_ahead=2, **TIER)), device="cpu")
    ts = tt._tier.adopt(b.restore(tt.init_state(seed=99, tiered=False)))
    assert ts.opt_state["count"] == 6
    _, ts, _ = _fit(_kw(), batches[6:], trainer=tt, state=ts)
    _assert_same(_snapshot(tt._tier.checkpoint_state(ts)), want)


def test_tasks_train_eval_export_tiered_serves_densified_forward(tmp_path):
    """``tasks.run`` train (two epochs, evals), eval, infer and export
    through the tier on the CPU: the checkpoint is dense, the artifact
    serves the tier's densified forward, and no kernel launches."""
    d = str(tmp_path / "data")
    libsvm.generate_synthetic_ctr(d, num_files=2, examples_per_file=200,
                                  seed=1, feature_size=300, field_size=5)
    for prefix, n, seed in (("va", 96, 2), ("te", 40, 3)):
        libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=n,
                                      seed=seed, prefix=prefix,
                                      feature_size=300, field_size=5)
    counts = (ek.plan_launches, ek.take_fwd_launches, ek.install_launches)
    cfg = Config(task_type="train", feature_size=300, field_size=5,
                 embedding_size=4, deep_layers="16,8", dropout="0.5,0.5",
                 batch_size=32, learning_rate=0.01, log_steps=5,
                 steps_per_loop=1, transfer_ahead=2, num_epochs=2,
                 shuffle_buffer=200, data_dir=d, val_data_dir=d,
                 model_dir=str(tmp_path / "ckpt"),
                 servable_model_dir=str(tmp_path / "sv"),
                 embedding_update="sparse", embedding_tiering="hot_cold",
                 embedding_hot_rows=256)
    res = tasks.run(cfg, device="cpu")
    steps = 2 * (400 // 32)
    assert res["steps"] == steps and np.isfinite(res["loss"])
    assert 0.0 < res["auc"] < 1.0
    assert res["hotcold_plans"] == steps and res["hotcold_installs"] > 0
    ev = tasks.run(cfg.replace(task_type="eval"), device="cpu")
    assert ev["auc"] == pytest.approx(res["auc"], abs=1e-6)
    inf = tasks.run(cfg.replace(task_type="infer"), device="cpu")
    assert inf["num_predictions"] == 40.0
    out = tasks.run(cfg.replace(task_type="export",
                                servable_model_dir=str(tmp_path / "sv2")),
                    device="cpu")
    artifact = os.path.join(str(tmp_path / "sv2"), str(int(out["step"])))
    serve = export_lib.load_serving(artifact, device="cpu")
    # The checkpoint is the dense layout: an untiered trainer restores it.
    dense_cfg = cfg.replace(embedding_tiering="off", embedding_hot_rows=0)
    dense = Trainer(dense_cfg, device="cpu")
    ds = ckpt_lib.CheckpointManager(cfg.model_dir).restore(dense.init_state())
    assert ds.params["fm_v"].shape[0] == dense.model.emb.padded_vocab
    tt = Trainer(cfg, device="cpu")
    ts = tasks._restore_or_init(tt, cfg.replace(task_type="export"),
                                require=True)
    assert ts.params["fm_v"].shape[0] == 256
    rng = np.random.default_rng(0)
    batch = {"feat_ids": rng.integers(0, 300, (32, 5)).astype(np.int32),
             "feat_vals": rng.random((32, 5), dtype=np.float32),
             "label": np.zeros((32, 1), np.float32)}
    want = next(tt.predict(ts, [batch]))
    np.testing.assert_array_equal(want, next(dense.predict(ds, [batch])))
    got = serve(batch["feat_ids"], batch["feat_vals"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (ek.plan_launches, ek.take_fwd_launches,
            ek.install_launches) == counts
