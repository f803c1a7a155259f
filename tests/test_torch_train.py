"""The port's training path (``deepfm_tpu_torch.train``, the train-mode
tower, the optimizers) against the JAX package's, on the CPU.

Every comparison starts from the same numbers: the JAX model's init is
carried into the port with ``params_from_jax`` and both sides see the same
numpy batches. Dropout masks cannot match (``jax.random`` vs a
``torch.Generator``), so parity runs use keep 1.0 and dropout is checked by
statistics. On the CPU the JAX side takes the plain FM formula and the
port's ``fused_fm`` its plain versions through the ``FusedFM`` autograd
function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.models import DeepFM as JaxDeepFM
from deepfm_tpu.models import common as jax_common
from deepfm_tpu.train import Trainer as JaxTrainer
from deepfm_tpu.train import metrics as jax_metrics
from deepfm_tpu.train import optimizers as jax_opt
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.models import common, get_model
from deepfm_tpu_torch.ops import embedding as emb
from deepfm_tpu_torch.train import Trainer, metrics, optimizers
from deepfm_tpu_torch.train import guard as guard_lib
from deepfm_tpu_torch.train.loop import check_ported, pad_batch, zero_batch
from deepfm_tpu_torch.utils.params import (flatten, opt_state_from_jax,
                                           params_from_jax)

torch.set_num_threads(1)

V, F, K, B = 500, 6, 8, 64

# float32: the same math summed in another order; 20 Adam steps stay within
# a few float32 ulps of the JAX trajectory (measured ~1e-7).
F32_LOSS_ATOL, F32_PARAM_ATOL = 1e-6, 2e-6
# bfloat16 towers: XLA and PyTorch accumulate the bf16 products in another
# order, so a hidden unit or a cotangent can land one bf16 ulp (2^-8
# relative) apart. Adam's normalized step turns such a difference on a
# gradient near zero into a sign flip worth up to 2*lr, so elements drift
# apart while the trajectory as a whole does not: the per-step loss agrees
# within 1e-4 (measured 2e-5), and the norm of the param difference stays
# under 3% of the norm of the params' movement over the 20 steps (measured
# 0.6%).
BF16_LOSS_ATOL, BF16_REL_MOVE = 1e-4, 0.03


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="1.0,1.0", batch_size=B,
                compute_dtype="float32", l2_reg=1e-3, learning_rate=5e-4,
                log_steps=0, seed=11, scale_lr_by_world=False, mesh_data=1,
                mesh_model=1, steps_per_loop=1, shuffle_buffer=100)
    base.update(kw)
    return base


def _batches(n, seed=0, bs=B):
    rng = np.random.default_rng(seed)
    return [{"label": rng.integers(0, 2, (bs, 1)).astype(np.float32),
             "feat_ids": rng.integers(0, V, (bs, F)).astype(np.int32),
             "feat_vals": rng.standard_normal((bs, F)).astype(np.float32)}
            for _ in range(n)]


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, tree)).items()}


def _pair(**kw):
    """JAX trainer + state, and the port's trainer + a state holding the
    same weights."""
    jt = JaxTrainer(JaxConfig(**_kw(**kw)))
    js = jt.init_state()
    tt = Trainer(Config(**_kw(**kw)), device="cpu")
    ts = tt.load_weights(tt.init_state(), *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    return jt, js, tt, ts


def _port_tree(ts):
    """A copy: the state's tensors are updated in place."""
    return {k: v.detach().numpy().copy() for k, v in {
        **ts.params, **ts.model_state}.items()}


# ---------------------------------------------------------------------------
# Tower in train mode
# ---------------------------------------------------------------------------

def test_batch_norm_train_matches_jax():
    """Batch statistics (biased variance, eps 1e-3) and the running update
    ``decay*old + (1-decay)*new``. float32, summed in another order."""
    rng = np.random.default_rng(1)
    h = rng.normal(1.0, 2.0, (32, 5)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 0.3, 5).astype(np.float32)
    mean0 = rng.normal(0, 0.3, 5).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    want, new = jax_common.batch_norm(
        jnp.asarray(h), jnp.asarray(scale), jnp.asarray(bias),
        {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)},
        train=True, decay=0.9)
    stats = common.RunningStats(5, device=torch.device("cpu"))
    stats.mean.copy_(torch.from_numpy(mean0))
    stats.var.copy_(torch.from_numpy(var0))
    got = common.batch_norm(torch.from_numpy(h), torch.from_numpy(scale),
                            torch.from_numpy(bias), stats, train=True,
                            decay=0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(stats.mean.numpy(), np.asarray(new["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(stats.var.numpy(), np.asarray(new["var"]),
                               rtol=1e-5, atol=1e-6)
    # Not nn.BatchNorm1d: its running variance is the unbiased one.
    assert not np.allclose(stats.var.numpy(), 0.9 * var0 + 0.1 * np.var(
        h, axis=0, ddof=1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("keep", [0.5, 0.8])
def test_dropout_keeps_and_scales(keep):
    """keep is a KEEP probability: about keep of the units survive, scaled
    by 1/keep, so the mean is preserved. 20k draws: the kept share lies
    within 0.01 of keep (> 5 standard deviations)."""
    h = torch.ones((100, 200), dtype=torch.bfloat16)
    out = common.dropout(h, keep, torch.Generator().manual_seed(0))
    assert out.dtype == torch.bfloat16
    kept = out != 0
    assert abs(float(kept.float().mean()) - keep) < 0.01
    np.testing.assert_allclose(out[kept].float().numpy(),
                               float(torch.tensor(1 / keep,
                                                  dtype=torch.bfloat16)))
    again = common.dropout(h, keep, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_train_mode_forward_draws_dropout_and_updates_bn():
    cfg = Config(**_kw(dropout="0.5,0.5", batch_norm=True))
    model = get_model(cfg, device="cpu").train()
    b = _batches(1)[0]
    ids, vals = torch.from_numpy(b["feat_ids"]), torch.from_numpy(b["feat_vals"])
    a = model(ids, vals, generator=torch.Generator().manual_seed(1))
    c = model(ids, vals, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a, c)
    assert not torch.all(model.bn[0].mean == 0)
    model.eval()
    with torch.no_grad():
        e1, e2 = model(ids, vals), model(ids, vals)
    assert torch.equal(e1, e2)


# ---------------------------------------------------------------------------
# l2 and pad rows
# ---------------------------------------------------------------------------

def test_l2_matches_jax_and_skips_pad_rows():
    jcfg = JaxConfig(**_kw(feature_size=100))
    jmodel = JaxDeepFM(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # Fill the pad rows: the l2 must not see them.
    fm_v = np.asarray(params["fm_v"]).copy()
    fm_v[100:] = rng.normal(size=fm_v[100:].shape)
    params = {**params, "fm_v": jnp.asarray(fm_v)}
    want = float(jmodel.l2_loss(params))
    model = get_model(Config(**_kw(feature_size=100)), device="cpu")
    tp = {k: torch.from_numpy(np.array(v)) for k, v in
          flatten(jax.tree.map(np.asarray, params)).items()}
    assert abs(float(model.l2_loss(tp)) - want) <= 1e-6 * abs(want)
    v = tp["fm_v"].clone().requires_grad_()
    g, = torch.autograd.grad(model.emb.l2(v), v)
    assert torch.all(g[100:] == 0) and torch.allclose(g[:100], v[:100])


def test_mask_pad_rows_matches_jax():
    from deepfm_tpu.ops import embedding as jax_emb
    x = np.random.default_rng(0).normal(size=(128, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        emb.mask_pad_rows(torch.from_numpy(x), 100).numpy(),
        np.asarray(jax_emb.mask_pad_rows(jnp.asarray(x), 100)))
    np.testing.assert_array_equal(
        emb.pad_row_mask(128, 100).numpy(),
        np.asarray(jax_emb.pad_row_mask(128, 100)))


def test_lookup_grad_matches_jnp_take_vjp():
    """Wrapped negative ids scatter to ``id + V``; out-of-range ids add
    nothing. float32 sums of a few terms: exact up to order (1e-6)."""
    v = 8
    rng = np.random.default_rng(0)
    table = rng.normal(size=(v, 3)).astype(np.float32)
    ids = np.array([[3, -1, v, -v], [-v - 1, 0, v - 1, 1000], [3, 3, -5, 2]],
                   np.int32)
    cot = rng.normal(size=(3, 4, 3)).astype(np.float32)

    def jax_f(t):
        out = jnp.take(t, jnp.asarray(ids), axis=0)
        return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out) * cot)

    want = np.asarray(jax.grad(jax_f)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = emb.lookup(t, torch.from_numpy(ids))
    torch.sum(torch.where(torch.isnan(out), 0.0, out)
              * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# One step's gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_norm", [False, True])
def test_step_grads_match_jax_grad(batch_norm):
    """loss = mean BCE + l2 over the full tables; pad-row grads zero.
    float32: the same sums in another order (rtol 1e-5, atol 1e-6)."""
    jt, js, tt, ts = _pair(batch_norm=batch_norm, feature_size=450)
    b = _batches(1, seed=3)[0]
    model = jt.model

    def loss_fn(params):
        logits, _ = model.apply(params, js.model_state,
                                jnp.asarray(b["feat_ids"]),
                                jnp.asarray(b["feat_vals"]), train=True)
        xent = jnp.mean(optax.sigmoid_binary_cross_entropy(
            logits, jnp.asarray(b["label"][:, 0])))
        return xent + model.l2_loss(params)

    jloss, jgrads = jax.value_and_grad(loss_fn)(js.params)
    # The JAX step zeroes pad-row grads after jax.grad (ids 450..499 of the
    # batch land on pad rows of this 450-row vocab).
    for n in ("fm_w", "fm_v"):
        jgrads[n] = model.emb.mask_pad_grads(jgrads[n])
    loss, _, grads = tt.loss_and_grads(ts, tt.put_batch(b))
    assert abs(float(loss) - float(jloss)) < 1e-6
    want = _np_tree(jgrads)
    assert set(want) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert torch.all(grads["fm_v"][450:] == 0)


# ---------------------------------------------------------------------------
# Optimizers against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Adam", "Adagrad", "Momentum", "sgd",
                                  "ftrl"])
def test_optimizer_matches_optax(name):
    """Five steps on the same grads (large ones, near-zero ones and exact
    zeros). float32 elementwise math in the same order; the bias
    corrections' pow may differ by an ulp, hence rtol 1e-5."""
    cfg_kw = _kw(optimizer=name, learning_rate=0.05)
    tx = jax_opt.build_optimizer(JaxConfig(**cfg_kw))
    opt = optimizers.build_optimizer(Config(**cfg_kw))
    rng = np.random.default_rng(2)
    p0 = {"a": rng.normal(size=(7, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = opt.init(tp)
    for step in range(5):
        g = {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-8, 1, v.shape)
                 ).astype(np.float32) for k, v in p0.items()}
        g["b"][step % 5] = 0.0
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} step {step} {k}")


def test_torch_optim_differs_from_optax():
    """Why the port repeats optax's arithmetic: torch.optim.Adagrad starts
    its accumulator at 0 and adds eps outside the root."""
    p = torch.zeros(3, requires_grad=True)
    ref = torch.optim.Adagrad([p], lr=0.1, initial_accumulator_value=1e-8)
    p.grad = torch.tensor([1e-5, 1.0, -2.0])
    ref.step()
    tx = optax.adagrad(0.1, initial_accumulator_value=1e-8)
    params = jnp.zeros(3)
    upd, _ = tx.update(jnp.asarray([1e-5, 1.0, -2.0]), tx.init(params), params)
    assert not np.allclose(p.detach().numpy(), np.asarray(upd), rtol=1e-3)


def test_lr_scales_by_world():
    cfg = Config(**_kw(scale_lr_by_world=True, learning_rate=0.1))
    assert optimizers.build_optimizer(cfg, world_size=4).lr == pytest.approx(0.4)
    assert optimizers.build_optimizer(cfg).lr == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# Trajectories
# ---------------------------------------------------------------------------

def _run_both(jt, js, tt, ts, batches):
    step = jt._make_train_step()
    jl, tl = [], []
    for b in batches:
        js, jm = step(js, jt.put_batch(b))
        ts, tm = tt.train_step(ts, tt.put_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return js, ts, np.array(jl), np.array(tl)


@pytest.mark.parametrize("compute_dtype,batch_norm", [
    ("float32", False), ("float32", True), ("bfloat16", False)])
def test_twenty_step_trajectory_matches_jax_trainer(compute_dtype,
                                                    batch_norm):
    jt, js, tt, ts = _pair(compute_dtype=compute_dtype,
                           batch_norm=batch_norm)
    p0 = _port_tree(ts)
    js, ts, jl, tl = _run_both(jt, js, tt, ts, _batches(20))
    want = {**_np_tree(js.params), **_np_tree(js.model_state)}
    got = _port_tree(ts)
    assert ts.step == int(js.step) == 20
    if compute_dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=0, atol=F32_LOSS_ATOL)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=F32_PARAM_ATOL, err_msg=k)
        return
    np.testing.assert_allclose(tl, jl, rtol=0, atol=BF16_LOSS_ATOL)
    diff = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
    moved = np.sqrt(sum(np.sum((want[k] - p0[k]) ** 2) for k in want))
    assert diff < BF16_REL_MOVE * moved, (diff, moved)


def test_resume_from_jax_opt_state_mid_trajectory():
    """Ten JAX steps, then the JAX params, BN state and Adam state carried
    into the port; ten more steps on both sides agree as the float32
    trajectory does."""
    jt, js, tt, ts = _pair()
    step = jt._make_train_step()
    batches = _batches(20, seed=5)
    for b in batches[:10]:
        js, _ = step(js, jt.put_batch(b))
    ts = tt.load_weights(ts, *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    ts.opt_state = opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state))
    ts.step = int(js.step)
    assert ts.opt_state["count"] == 10
    js, ts, jl, tl = _run_both(jt, js, tt, ts, batches[10:])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=F32_LOSS_ATOL)
    want = _np_tree(js.params)
    for k, v in ts.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0,
                                   atol=F32_PARAM_ATOL, err_msg=k)


def test_multi_step_equals_train_steps():
    tt = Trainer(Config(**_kw(dropout="0.7,0.7")), device="cpu")
    a, b = tt.init_state(), tt.init_state()
    batches = [tt.put_batch(x) for x in _batches(3)]
    for x in batches:
        a, ma = tt.train_step(a, x)
    b, mb = tt.multi_step(b, batches)
    assert a.step == b.step == 3 and torch.equal(ma["loss"], mb["loss"])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_fit_hooks_log_cadence_and_tail():
    """steps_per_loop 4 over 10 batches: dispatches of 4, 4, 1, 1; the
    loss is read back only at log_steps boundaries."""
    tt = Trainer(Config(**_kw(steps_per_loop=4, log_steps=5)), device="cpu")
    seen, logged = [], []
    state, out = tt.fit(tt.init_state(), _batches(10),
                        hooks=[lambda s, m: seen.append(m["steps_done"])],
                        on_log=lambda step, loss, eps: logged.append(step))
    assert seen == [4, 4, 1, 1] and state.step == 10
    assert logged == [8, 10] and out["steps"] == 10.0
    assert np.isfinite(out["loss"])


def test_nonfinite_loss_aborts_at_log_cadence():
    tt = Trainer(Config(**_kw(log_steps=1)), device="cpu")
    state = tt.init_state()
    with torch.no_grad():
        state.params["fm_b"].fill_(float("nan"))
    with pytest.raises(guard_lib.NonFiniteError, match="step 1"):
        tt.fit(state, _batches(2), guard=guard_lib.NonFiniteGuard())


def test_loss_spike_detector_counts_and_keeps_going():
    g = guard_lib.NonFiniteGuard(spike_zscore=4.0, spike_warmup=5)
    losses = [0.70, 0.69, 0.71, 0.70, 0.69, 0.70, 0.71, 5.0, 0.70]
    assert [g.observe(x, i) for i, x in enumerate(losses)] == ["ok"] * 9
    assert g.health.snapshot() == {
        "preemptions": 0, "nonfinite_skips": 0, "rollbacks": 0,
        "watchdog_aborts": 0, "loss_spikes": 1, "resume_meta_corrupt": 0}
    with pytest.raises(guard_lib.NonFiniteError, match="non-finite param"):
        g.observe(0.7, 9, params_bad=True)


@pytest.mark.parametrize("policy", ["skip", "rollback"])
def test_unported_guard_policies_raise(policy):
    """skip and rollback are ported: they build, check every dispatch and
    return their verdict; only an unknown policy raises."""
    g = guard_lib.NonFiniteGuard(policy)
    assert g.per_dispatch and g.observe(float("nan"), 3) == policy
    with pytest.raises(ValueError, match="on_nonfinite"):
        guard_lib.NonFiniteGuard(policy + "x")


@pytest.mark.parametrize("flag,value,match", [
    ("mesh_model", 2, "--mesh_model"),
    ("grad_accum_steps", 2, "--grad_accum_steps"),
    ("mesh_data", 2, "--mesh_data"),
    ("dispatch_timeout_s", 5.0, "--dispatch_timeout_s"),
])
def test_unported_trainer_flags_raise(flag, value, match):
    """A mesh other than 1x1 still raises naming its flag; gradient
    accumulation and the stall watchdog are ported and pass."""
    kw = _kw(**{flag: value})
    if flag == "grad_accum_steps":
        kw["steps_per_loop"] = 2
    if flag in ("grad_accum_steps", "dispatch_timeout_s"):
        check_ported(Config(**kw))
        assert Trainer(Config(**kw), device="cpu").cfg.to_dict()[flag] == value
        return
    with pytest.raises(NotImplementedError, match=match):
        check_ported(Config(**kw))


# ---------------------------------------------------------------------------
# Evaluate and metrics
# ---------------------------------------------------------------------------

def test_evaluate_with_ragged_tail_matches_jax():
    """Two full batches and a 17-row tail, padded at zero weight on both
    sides. float32 forward; AUC bins can only move for a probability within
    an ulp of a bin edge (atol 1e-6), the mean loss sums in another order."""
    jt, js, tt, ts = _pair()
    batches = _batches(3, seed=9)
    batches[-1] = {k: v[:17] for k, v in batches[-1].items()}
    want = jt.evaluate(js, iter(batches))
    got = tt.evaluate(ts, iter(batches))
    assert got["batches"] == want["batches"] == 3.0
    assert abs(got["auc"] - want["auc"]) < 1e-6
    assert abs(got["loss"] - want["loss"]) < 1e-6
    assert pad_batch(batches[-1], B)["label"].shape == (B, 1)
    assert zero_batch(F, 4)["feat_ids"].shape == (4, F)


def test_auc_bins_equal_jax_on_identical_probs():
    rng = np.random.default_rng(4)
    probs = rng.random(5000).astype(np.float32)
    probs[:50] = np.linspace(0, 1, 50, dtype=np.float32)  # edges, 0 and 1
    labels = (rng.random(5000) < probs).astype(np.float32)
    w = (rng.random(5000) < 0.9).astype(np.float32)
    want = jax_metrics.auc_update(jax_metrics.auc_init(200),
                                  jnp.asarray(probs), jnp.asarray(labels),
                                  jnp.asarray(w))
    got = metrics.auc_update(metrics.auc_init(200), torch.from_numpy(probs),
                             torch.from_numpy(labels), torch.from_numpy(w))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.neg.numpy(), np.asarray(want.neg))
    assert abs(float(metrics.auc_compute(got))
               - float(jax_metrics.auc_compute(want))) < 1e-6
    assert abs(float(metrics.auc_compute(got))
               - metrics.auc_numpy_reference(probs[w > 0], labels[w > 0])
               ) < 0.01


def test_auc_one_class_is_nan_and_mean_state():
    s = metrics.auc_update(metrics.auc_init(10), torch.tensor([0.2, 0.7]),
                           torch.tensor([1.0, 1.0]))
    assert np.isnan(float(metrics.auc_compute(s)))
    assert np.isnan(metrics.auc_numpy_reference([0.2, 0.7], [1, 1]))
    m = metrics.MeanState(total=torch.tensor(6.0), count=torch.tensor(2.0))
    assert float(metrics.mean_compute(m)) == 3.0
    assert float(metrics.mean_compute(metrics.mean_init())) == 0.0
    merged = metrics.auc_merge(s, s)
    assert float(merged.pos.sum()) == 4.0
