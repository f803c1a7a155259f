"""The port's sparse embedding update (``--embedding_update sparse``) and
hash-bucketed tables (``--embedding_buckets``) against the JAX package's,
on the CPU.

Both sides start from the same numbers: the JAX init is carried into the
port with ``params_from_jax`` and both see the same numpy batches (dropout
keep 1.0). On the CPU the port's kernel wrappers take their plain versions,
whose plans are bit-equal to the JAX legs' and whose segment-sums add in
the JAX order, so the trajectories differ only by the float32 sum order of
the forward and backward of the tower and FM (the same source as the dense
trajectory tests).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.models import DeepFM as JaxDeepFM
from deepfm_tpu.models import common as jax_common
from deepfm_tpu.train import Trainer as JaxTrainer
from deepfm_tpu.train import optimizers as jax_opt
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.models import common, get_model
from deepfm_tpu_torch.ops import embedding_kernels as ek
from deepfm_tpu_torch.train import Trainer, optimizers, tasks
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils.params import (flatten, opt_state_from_jax,
                                           params_from_jax)

torch.set_num_threads(1)

V, F, K, B = 500, 6, 8, 64
BUCKETS = "97,131,61"

# 20 float32 steps at lr 5e-4 (measured: loss 1.8e-7, params 3.0e-8, m
# 1.4e-9, v 9e-7 of its largest value): the float32 sum order of the tower
# and FM between XLA and PyTorch, as in the dense trajectory tests.
LOSS_ATOL, PARAM_ATOL, M_ATOL, V_RTOL = 1e-6, 2e-6, 1e-7, 1e-5

LAYOUTS = {
    "monolithic": {},
    "monolithic_off": {"embedding_kernels": "off"},
    "hashed": {"embedding_buckets": BUCKETS},
    "hashed_field": {"embedding_buckets": BUCKETS,
                     "embedding_assign": "field"},
}


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="1.0,1.0", batch_size=B,
                compute_dtype="float32", l2_reg=1e-3, learning_rate=5e-4,
                log_steps=0, seed=11, scale_lr_by_world=False, mesh_data=1,
                mesh_model=1, steps_per_loop=1, embedding_update="sparse")
    base.update(kw)
    return base


def _batches(n, seed=0, vocab=V):
    rng = np.random.default_rng(seed)
    return [{"label": rng.integers(0, 2, (B, 1)).astype(np.float32),
             "feat_ids": rng.integers(0, vocab, (B, F)).astype(np.int32),
             "feat_vals": rng.standard_normal((B, F)).astype(np.float32)}
            for _ in range(n)]


def _np(tree):
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, tree)).items()}


def _pair(**kw):
    jt = JaxTrainer(JaxConfig(**_kw(**kw)))
    js = jt.init_state()
    assert jt.sparse_embed
    tt = Trainer(Config(**_kw(**kw)), device="cpu")
    ts = tt.load_weights(tt.init_state(), *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    return jt, js, tt, ts


def _run_both(jt, js, tt, ts, batches):
    step = jt._make_train_step()
    jl, tl = [], []
    for b in batches:
        js, jm = step(js, jt.put_batch(b))
        ts, tm = tt.train_step(ts, tt.put_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return js, ts, np.array(jl), np.array(tl)


def _assert_state_matches(js, ts):
    want = _np(js.params)
    assert set(want) == set(ts.params)
    for k, v in ts.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    je, te = js.opt_state["embed"], ts.opt_state["embed"]
    assert set(je) == set(te)
    for name in je:
        assert set(je[name]) == set(te[name])
        for key, e in je[name].items():
            got = te[name][key]
            np.testing.assert_array_equal(got.tau.numpy(), np.asarray(e.tau))
            np.testing.assert_allclose(got.m.numpy(), np.asarray(e.m), rtol=0,
                                       atol=M_ATOL)
            v = np.asarray(e.v)
            np.testing.assert_allclose(got.v.numpy(), v, rtol=0,
                                       atol=V_RTOL * np.abs(v).max())
    assert ts.opt_state["count"] == int(js.opt_state["count"]) == ts.step


def _snapshot(ts):
    """A copy (the state's tensors are updated in place)."""
    out = {k: v.detach().clone() for k, v in ts.params.items()}
    for name, tabs in ts.opt_state["embed"].items():
        for key, e in tabs.items():
            for f in e._fields:
                out[f"opt.{name}.{key}.{f}"] = getattr(e, f).clone()
    return out


# ---------------------------------------------------------------------------
# Hashed schema against the JAX one
# ---------------------------------------------------------------------------

def _schemas(**kw):
    return (jax_common.EmbeddingSchema(JaxConfig(**_kw(**kw))),
            common.EmbeddingSchema(Config(**_kw(**kw))))


@pytest.mark.parametrize("assign", ["hash", "field"])
def test_hashed_schema_lookup_plan_rows_and_l2_match_jax(assign):
    js, ts = _schemas(embedding_buckets=BUCKETS, embedding_assign=assign)
    assert ts.table_keys() == js.table_keys() == ["t0", "t1", "t2"]
    assert ts.num_physical_rows() == js.num_physical_rows() == 289
    rng = np.random.default_rng(3)
    tables = {f"t{i}": rng.standard_normal((b, K)).astype(np.float32)
              for i, b in enumerate((97, 131, 61))}
    jent = {k: jnp.asarray(v) for k, v in tables.items()}
    tent = {k: torch.from_numpy(v) for k, v in tables.items()}
    ids = _batches(1, seed=4, vocab=10 ** 6)[0]["feat_ids"]
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    np.testing.assert_array_equal(ts.lookup(tent, tids).numpy(),
                                  np.asarray(js.lookup(jent, jids)))
    jplan, tplan = js.sparse_plan(jids), ts.sparse_plan(tids)
    assert list(jplan) == list(tplan)
    for k in jplan:
        for f in ("uids", "inv", "mask", "touched"):
            np.testing.assert_array_equal(getattr(tplan[k], f).numpy(),
                                          np.asarray(getattr(jplan[k], f)))
        assert tplan[k].num_rows == jplan[k].num_rows
    jrows, trows = js.gather_rows(jent, jplan), ts.gather_rows(tent, tplan)
    for k in jrows:
        np.testing.assert_array_equal(trows[k].numpy(), np.asarray(jrows[k]))
    np.testing.assert_array_equal(ts.lookup_rows(trows, tplan).numpy(),
                                  np.asarray(js.lookup_rows(jrows, jplan)))
    # One float32 sum per table, taken in another order: 1e-6 relative.
    np.testing.assert_allclose(float(ts.l2_rows(trows, tplan)),
                               float(js.l2_rows(jrows, jplan)), rtol=1e-6)
    np.testing.assert_allclose(float(ts.l2(tent)), float(js.l2(jent)),
                               rtol=1e-6)
    assert ts.mask_pad_grads(tent["t0"]) is tent["t0"]


def test_hashed_params_flatten_like_the_jax_tree():
    """``params_from_jax`` flattens the hashed entries to ``fm_v.t0``, ...,
    which are the port model's state names, so a JAX init loads as is."""
    cfg = _kw(embedding_buckets=BUCKETS)
    jparams, jstate = JaxDeepFM(JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    params, state = params_from_jax(jax.tree.map(np.asarray, jparams),
                                    jax.tree.map(np.asarray, jstate))
    model = get_model(Config(**cfg), device="cpu")
    assert {k: tuple(v.shape) for k, v in {**params, **state}.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert "fm_v.t2" in params and params["fm_w.t1"].shape == (131,)
    model.load_state_dict({**params, **state})


# ---------------------------------------------------------------------------
# Lazy Adam against the JAX package's
# ---------------------------------------------------------------------------

def test_sparse_adam_rows_matches_jax():
    """Idle counts from 1 to 9 at step 12; float32 elementwise math in the
    JAX order, bias corrections computed on the host (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    u, d, count = 9, 4, 12
    rows0, g, m, v = (rng.standard_normal((u, d)).astype(np.float32)
                      for _ in range(4))
    v = np.abs(v)
    tau = (count - 1 - np.arange(u)).astype(np.int32)
    want = jax_opt.sparse_adam_rows(*map(jnp.asarray, (rows0, g, m, v, tau)),
                                    jnp.int32(count), lr=0.01)
    got = optimizers.sparse_adam_rows(*map(torch.from_numpy,
                                           (rows0, g, m, v, tau)),
                                      count, lr=0.01)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_sparse_adam_masked_matches_jax_and_keeps_untouched_bits():
    rng = np.random.default_rng(1)
    r, d, count = 16, 3, 7
    table, g, m, v = (rng.standard_normal((r, d)).astype(np.float32)
                      for _ in range(4))
    v = np.abs(v)
    tau = rng.integers(0, count, r).astype(np.int32)
    touched = rng.random(r) < 0.5
    jt, jo = jax_opt.sparse_adam_masked(
        jnp.asarray(table), jnp.asarray(g), jnp.asarray(touched),
        jax_opt.EmbedAdamEntry(jnp.asarray(m), jnp.asarray(v),
                               jnp.asarray(tau)), jnp.int32(count), lr=0.01)
    tt = torch.from_numpy(table.copy())
    oe = optimizers.EmbedAdamEntry(torch.from_numpy(m.copy()),
                                   torch.from_numpy(v.copy()),
                                   torch.from_numpy(tau.copy()))
    optimizers.sparse_adam_masked(tt, torch.from_numpy(g),
                                  torch.from_numpy(touched), oe, count,
                                  lr=0.01)
    for a, b in ((tt, jt), (oe.m, jo.m), (oe.v, jo.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(oe.tau.numpy(), np.asarray(jo.tau))
    np.testing.assert_array_equal(tt.numpy()[~touched], table[~touched])
    np.testing.assert_array_equal(oe.m.numpy()[~touched], m[~touched])


# ---------------------------------------------------------------------------
# Trainer trajectories against the JAX Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_twenty_step_sparse_trajectory_matches_jax_trainer(layout):
    """Per-step loss, params, lazy-Adam m and v within the float32 band;
    tau and the step counts exact."""
    jt, js, tt, ts = _pair(**LAYOUTS[layout])
    fused = not tt.model.emb.hashed and tt.cfg.embedding_kernels != "off"
    assert tt._use_fused_backward() == jt._use_fused_backward() == fused
    js, ts, jl, tl = _run_both(jt, js, tt, ts, _batches(20))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    _assert_state_matches(js, ts)


def test_resume_from_jax_sparse_opt_state_mid_trajectory():
    """Ten JAX steps, then params, BN state and the sparse optimizer state
    (optax Adam under base, m/v/tau per table, count) carried into the
    port; ten more steps on both sides agree as the trajectory does."""
    jt, js, tt, ts = _pair(embedding_buckets=BUCKETS)
    step = jt._make_train_step()
    batches = _batches(20, seed=5)
    for b in batches[:10]:
        js, _ = step(js, jt.put_batch(b))
    ts = tt.load_weights(ts, *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    ts.opt_state = opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state))
    ts.step = int(js.step)
    assert ts.opt_state["count"] == ts.opt_state["base"]["count"] == 10
    assert ts.opt_state["embed"]["fm_v"]["t1"].tau.dtype == torch.int32
    js, ts, jl, tl = _run_both(jt, js, tt, ts, batches[10:])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    _assert_state_matches(js, ts)


# ---------------------------------------------------------------------------
# Touch set, pad rows, kernel legs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["monolithic", "hashed"])
def test_untouched_rows_bit_frozen_and_tau_stamped(layout):
    tt = Trainer(Config(**_kw(**LAYOUTS[layout])), device="cpu")
    ts = tt.init_state()
    before = _snapshot(ts)
    batch = _batches(1, seed=5)[0]
    ts, _ = tt.train_step(ts, tt.put_batch(batch))
    emb = tt.model.emb
    ids = torch.from_numpy(batch["feat_ids"])
    for key, entry in emb.sparse_plan(ids).items():
        touched = torch.zeros(entry.num_rows, dtype=torch.bool)
        real = entry.uids[entry.uids < entry.num_rows].long()
        touched[real] = True
        for name in ("fm_w", "fm_v"):
            p = emb.param_key(name, key)
            now, was = ts.params[p].detach(), before[p]
            assert torch.equal(now[~touched], was[~touched]), p
            assert not torch.equal(now[touched], was[touched]), p
            tau = ts.opt_state["embed"][name][key].tau
            assert torch.all(tau[touched] == 1)
            assert torch.all(tau[~touched] == 0)


def test_pad_rows_stay_bit_zero():
    """feature_size 450 pads to 512 rows; ids reach the pad rows never,
    so no step moves them (monolithic, fused and plan legs)."""
    for kernels in ("auto", "off"):
        tt = Trainer(Config(**_kw(feature_size=450,
                                  embedding_kernels=kernels)), device="cpu")
        ts = tt.init_state()
        for b in _batches(4, vocab=450):
            ts, _ = tt.train_step(ts, tt.put_batch(b))
        for name in ("fm_w", "fm_v"):
            assert ts.params[name].shape[0] == 512
            assert torch.all(ts.params[name][450:] == 0), (kernels, name)


def _trained(n_steps, **kw):
    tt = Trainer(Config(**_kw(**kw)), device="cpu")
    ts = tt.init_state()
    losses = []
    for b in _batches(n_steps, seed=2):
        ts, m = tt.train_step(ts, tt.put_batch(b))
        losses.append(float(m["loss"]))
    return _snapshot(ts), np.array(losses)


@pytest.mark.parametrize("kernels", ["xla", "off"])
def test_hashed_kernel_legs_bit_identical(kernels):
    """Hashed layout: the plan legs give identical plans and the take legs
    identical values and segment-sums, so the whole state is bit-equal."""
    a, la = _trained(6, embedding_buckets=BUCKETS)
    b, lb = _trained(6, embedding_buckets=BUCKETS, embedding_kernels=kernels)
    np.testing.assert_array_equal(la, lb)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_monolithic_fused_vs_plan_leg_within_adam_tail_band():
    """Monolithic ``auto`` (fused table sweep, exp2 decays) vs ``off``
    (plan path, pow decays): the same gradients, an Adam tail that rounds
    an ulp or two apart, so params within 1e-6 (the JAX package's band)
    and tau exact."""
    a, la = _trained(8, l2_reg=1e-4)
    b, lb = _trained(8, l2_reg=1e-4, embedding_kernels="off")
    np.testing.assert_allclose(la, lb, rtol=0, atol=1e-6)
    for k in a:
        if a[k].dtype == torch.int32:
            assert torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


def test_multi_step_equals_train_steps():
    tt = Trainer(Config(**_kw(embedding_buckets=BUCKETS)), device="cpu")
    a, b = tt.init_state(), tt.init_state()
    batches = [tt.put_batch(x) for x in _batches(3)]
    for x in batches:
        a, ma = tt.train_step(a, x)
    b, mb = tt.multi_step(b, batches)
    assert a.step == b.step == 3 and torch.equal(ma["loss"], mb["loss"])
    sa, sb = _snapshot(a), _snapshot(b)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ---------------------------------------------------------------------------
# Checkpoints and tasks
# ---------------------------------------------------------------------------

def test_sparse_checkpoint_resume_is_bit_identical(tmp_path):
    """Six steps, a checkpoint, a restore into a fresh state and six more
    steps end bit-equal to twelve uninterrupted steps (CPU: the same sums
    in the same order)."""
    cfg = Config(**_kw(embedding_buckets=BUCKETS))
    batches = _batches(12, seed=8)
    tt = Trainer(cfg, device="cpu")
    full = tt.init_state()
    for b in batches:
        full, _ = tt.train_step(full, tt.put_batch(b))
    cut = tt.init_state()
    for b in batches[:6]:
        cut, _ = tt.train_step(cut, tt.put_batch(b))
    mgr = ckpt_lib.CheckpointManager(str(tmp_path))
    mgr.save(cut.step, cut)
    resumed = mgr.restore(tt.init_state(seed=99))
    assert resumed.opt_state["count"] == 6
    assert isinstance(resumed.opt_state["embed"]["fm_w"]["t0"],
                      optimizers.EmbedAdamEntry)
    for b in batches[6:]:
        resumed, _ = tt.train_step(resumed, tt.put_batch(b))
    sf, sr = _snapshot(full), _snapshot(resumed)
    for k in sf:
        assert torch.equal(sf[k], sr[k]), k


def test_tasks_train_eval_export_hashed_sparse_serves(tmp_path):
    """``tasks.run`` train (two epochs, evals), eval, infer and export with
    the hashed sparse layout on the CPU; the artifact serves the trainer's own
    predictions, and the CPU run launches no kernel."""
    d = str(tmp_path / "data")
    libsvm.generate_synthetic_ctr(d, num_files=2, examples_per_file=200,
                                  seed=1, feature_size=300, field_size=5)
    for prefix, n, seed in (("va", 96, 2), ("te", 40, 3)):
        libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=n,
                                      seed=seed, prefix=prefix,
                                      feature_size=300, field_size=5)
    counts = (ek.plan_launches, ek.take_fwd_launches, ek.take_bwd_launches)
    cfg = Config(task_type="train", feature_size=300, field_size=5,
                 embedding_size=4, deep_layers="16,8", dropout="0.5,0.5",
                 batch_size=32, learning_rate=0.01, log_steps=5,
                 steps_per_loop=4, num_epochs=2, shuffle_buffer=200,
                 data_dir=d, val_data_dir=d,
                 model_dir=str(tmp_path / "ckpt"),
                 servable_model_dir=str(tmp_path / "sv"),
                 embedding_update="sparse", embedding_buckets="64,48,80")
    res = tasks.run(cfg, device="cpu")
    assert res["steps"] == 2 * (400 // 32) and np.isfinite(res["loss"])
    assert 0.0 < res["auc"] < 1.0
    ev = tasks.run(cfg.replace(task_type="eval"), device="cpu")
    assert ev["auc"] == pytest.approx(res["auc"], abs=1e-6)
    inf = tasks.run(cfg.replace(task_type="infer"), device="cpu")
    assert inf["num_predictions"] == 40.0
    out = tasks.run(cfg.replace(task_type="export",
                                servable_model_dir=str(tmp_path / "sv2")),
                    device="cpu")
    artifact = os.path.join(str(tmp_path / "sv2"), str(int(out["step"])))
    serve = export_lib.load_serving(artifact, device="cpu")
    trainer = Trainer(cfg, device="cpu")
    state = ckpt_lib.CheckpointManager(cfg.model_dir).restore(
        trainer.init_state())
    assert state.opt_state["count"] == res["steps"]
    rng = np.random.default_rng(0)
    batch = {"feat_ids": rng.integers(0, 300, (32, 5)).astype(np.int32),
             "feat_vals": rng.random((32, 5), dtype=np.float32),
             "label": np.zeros((32, 1), np.float32)}
    want = next(trainer.predict(state, [batch]))
    got = serve(batch["feat_ids"], batch["feat_vals"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (ek.plan_launches, ek.take_fwd_launches,
            ek.take_bwd_launches) == counts
