"""The port's gradient accumulation (``--grad_accum_steps``) against the
JAX package's, on the CPU.

Both sides start from the same numbers: the JAX init is carried into the
port with ``params_from_jax`` and both see the same numpy batches (dropout
keep 1.0). Each runs ``fit`` over 8 microbatches with ``steps_per_loop`` 4,
so k = 2 makes four accumulated applies and k = 4 two. The layouts: the
dense update, the sparse monolithic fused leg, the sparse monolithic plan
leg (``--embedding_kernels off``) and hashed tables. On the CPU the
kernel wrappers take their plain versions.

Tolerances: parameters within rtol 2e-5, atol 1e-6, the JAX package's own
accumulation tolerance (``tests/test_scaling_overlap.py``); both sides add
the same terms in another float32 order (measured: at most 3.5e-7 above
rtol). Bit identity where the port runs the same arithmetic twice.
"""

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.train import Trainer as JaxTrainer
from deepfm_tpu.train import tasks as jax_tasks
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.ops import embedding_kernels as ek
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.train import guard as guard_lib
from deepfm_tpu_torch.utils.params import flatten, params_from_jax

torch.set_num_threads(1)

V, F, K, B = 500, 6, 8, 64
RTOL, ATOL = 2e-5, 1e-6
LOSS_ATOL = 1e-6
BUCKETS = "97,131,61"

LAYOUTS = {
    "dense": {},
    "dense_bn": {"batch_norm": True},
    "fused": {"embedding_update": "sparse"},
    "plan_off": {"embedding_update": "sparse", "embedding_kernels": "off"},
    "hashed": {"embedding_update": "sparse", "embedding_buckets": BUCKETS},
}


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="1.0,1.0", batch_size=B,
                compute_dtype="float32", l2_reg=1e-3, learning_rate=5e-4,
                log_steps=0, seed=11, scale_lr_by_world=False, mesh_data=1,
                mesh_model=1, steps_per_loop=4, transfer_ahead=0,
                shuffle_buffer=100)
    base.update(kw)
    return base


def _batches(n, seed=0, bs=B):
    rng = np.random.default_rng(seed)
    return [{"label": rng.integers(0, 2, (bs, 1)).astype(np.float32),
             "feat_ids": rng.integers(0, V, (bs, F)).astype(np.int32),
             "feat_vals": rng.standard_normal((bs, F)).astype(np.float32)}
            for _ in range(n)]


def _np(tree):
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, tree)).items()}


def _pair(**kw):
    jt = JaxTrainer(JaxConfig(**_kw(**kw)))
    js = jt.init_state()
    tt = Trainer(Config(**_kw(**kw)), device="cpu")
    ts = tt.load_weights(tt.init_state(), *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    return jt, js, tt, ts


def _snapshot(ts):
    """A copy of every tensor of the state (they update in place)."""
    out = {f"p.{k}": v.detach().clone() for k, v in ts.params.items()}
    out.update({f"s.{k}": v.clone() for k, v in ts.model_state.items()})
    opt = ts.opt_state
    if "embed" in opt:
        for name, tabs in opt["embed"].items():
            for key, e in tabs.items():
                for f in e._fields:
                    out[f"e.{name}.{key}.{f}"] = getattr(e, f).clone()
        opt = opt["base"]
    for slot in ("mu", "nu"):
        for k, v in opt.get(slot, {}).items():
            out[f"{slot}.{k}"] = v.clone()
    return out


def _assert_bits(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _count(ts):
    """The optimizer's apply count (dense Adam's, or the sparse update's
    embedding count)."""
    return ts.opt_state["count"]


# ---------------------------------------------------------------------------
# Against the JAX Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_accumulation_matches_jax_trainer(layout, k):
    """fit over 8 microbatches at grad_accum_steps k on both sides: the
    params (and the BN running statistics) within rtol 2e-5, atol 1e-6,
    the last logged loss within 1e-6; step counts microbatches and count
    counts applies on both sides."""
    jt, js, tt, ts = _pair(grad_accum_steps=k, **LAYOUTS[layout])
    if tt.sparse_embed:
        assert tt._use_fused_backward() == jt._use_fused_backward()
    batches = _batches(8)
    js, jo = jt.fit(js, iter(batches))
    ts, to = tt.fit(ts, batches)
    assert ts.step == int(js.step) == 8 and to["steps"] == 8
    assert _count(ts) == int(np.asarray(js.opt_state["count"])
                             if tt.sparse_embed else 8 // k) == 8 // k
    assert abs(to["loss"] - jo["loss"]) <= LOSS_ATOL
    want = {**_np(js.params), **_np(js.model_state)}
    got = {k_: v.detach().numpy() for k_, v in {
        **ts.params, **ts.model_state}.items()}
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("layout", ["dense", "fused", "hashed"])
def test_accumulation_matches_the_big_batch_step(layout, k):
    """k microbatches and one apply equal one step over their concatenated
    k*B examples, up to float reassociation (the JAX package's own
    accumulation contract, held here within the port)."""
    micro = _batches(4)
    cfg = Config(**_kw(grad_accum_steps=k, **LAYOUTS[layout]))
    ta = Trainer(cfg, device="cpu")
    sa, _ = ta.fit(ta.init_state(), micro)
    big = [{key: np.concatenate([m[key] for m in micro[i:i + k]])
            for key in micro[0]} for i in range(0, 4, k)]
    tb = Trainer(Config(**_kw(batch_size=B * k, steps_per_loop=4 // k,
                              **LAYOUTS[layout])), device="cpu")
    sb, _ = tb.fit(tb.init_state(), big)
    assert sa.step == 4 and sb.step == 4 // k
    for name, v in sa.params.items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   sb.params[name].detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# Bit identity and counters within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k1_bit_identical_to_no_accumulation(layout):
    """At grad_accum_steps 1 fit runs the single-step path, and one
    accumulated apply over a single microbatch is the very step the port
    takes without accumulation: both bit-identical to train_step."""
    cfg = Config(**_kw(**LAYOUTS[layout]))
    tt = Trainer(cfg, device="cpu")
    assert tt._accum == 1
    batches = [tt.put_batch(b) for b in _batches(4)]
    ref = tt.init_state()
    ref_losses = []
    for b in batches:
        ref, m = tt.train_step(ref, b)
        ref_losses.append(m["loss"])
    fitted, _ = tt.fit(tt.init_state(), _batches(4))
    one = tt.init_state()
    one_losses = []
    for b in batches:
        one, m = tt._accum_step_impl(one, [b])
        one_losses.append(m["loss"])
    want = _snapshot(ref)
    _assert_bits(want, _snapshot(fitted))
    _assert_bits(want, _snapshot(one))
    assert torch.equal(torch.stack(ref_losses), torch.stack(one_losses))
    assert fitted.step == one.step == ref.step == 4


@pytest.mark.parametrize("layout", ["dense", "fused", "plan_off", "hashed"])
def test_step_counts_microbatches_and_count_counts_applies(layout):
    tt = Trainer(Config(**_kw(grad_accum_steps=4, steps_per_loop=8,
                              **LAYOUTS[layout])), device="cpu")
    st, out = tt.fit(tt.init_state(), _batches(16))
    assert st.step == 16 and out["steps"] == 16
    assert _count(st) == 4
    if tt.sparse_embed:
        assert st.opt_state["base"]["count"] == 4
        taus = {int(e.tau.max()) for tabs in st.opt_state["embed"].values()
                for e in tabs.values()}
        assert taus == {4}  # rows stamped with the apply count


@pytest.mark.parametrize("layout", ["dense", "hashed"])
def test_tail_regrouping_k_mod_a_full_steps(layout):
    """multi_step over 5 microbatches at a = 2: two accumulated applies,
    then one full single step, bit for bit; in fit, full groups of
    steps_per_loop accumulate and the tail batches run as single steps
    (as the JAX package stages them: the count matches its count)."""
    cfg = Config(**_kw(grad_accum_steps=2, **LAYOUTS[layout]))
    tt = Trainer(cfg, device="cpu")
    batches = [tt.put_batch(b) for b in _batches(5)]
    a, _ = tt.multi_step(tt.init_state(), batches)
    b = tt.init_state()
    b, _ = tt._accum_step_impl(b, batches[:2])
    b, _ = tt._accum_step_impl(b, batches[2:4])
    b, _ = tt.train_step(b, batches[4])
    _assert_bits(_snapshot(a), _snapshot(b))
    assert a.step == 5 and _count(a) == 3

    jt, js, tt, ts = _pair(grad_accum_steps=2, **LAYOUTS[layout])
    seven = _batches(7, seed=4)
    js, _ = jt.fit(js, iter(seven))
    ts, out = tt.fit(ts, seven)
    assert ts.step == int(js.step) == 7 and out["steps"] == 7
    assert _count(ts) == 2 + 3
    for name, v in ts.params.items():
        np.testing.assert_allclose(v.detach().numpy(), _np(js.params)[name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("layout", ["dense", "fused", "hashed"])
def test_same_seed_accumulation_runs_bit_identical_with_dropout(layout):
    """Dropout on (drawn in microbatch order from the state's generator):
    two same-seed runs give the same losses and tables, bit for bit."""
    kw = _kw(grad_accum_steps=2, dropout="0.5,0.5", **LAYOUTS[layout])
    outs = []
    for _ in range(2):
        tt = Trainer(Config(**kw), device="cpu")
        losses = []
        st, _ = tt.fit(tt.init_state(), _batches(8), hooks=[
            lambda s, m: losses.append(m["loss"])])
        outs.append((torch.stack(losses), _snapshot(st)))
    assert torch.equal(outs[0][0], outs[1][0])
    _assert_bits(outs[0][1], outs[1][1])


def _counting(monkeypatch, obj, name):
    calls = [0]
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)
    monkeypatch.setattr(obj, name, wrapped)
    return calls


def test_hashed_apply_builds_one_merged_plan_and_one_take_per_name(
        monkeypatch):
    """Per apply of the plan leg: one plan over the group's a*B ids (every
    table's, merged), one fused take forward per name over the merged inv
    and one take backward per name: as often as one step without
    accumulation."""
    tt = Trainer(Config(**_kw(grad_accum_steps=4, **LAYOUTS["hashed"])),
                 device="cpu")
    emb = tt.model.emb
    shapes = []
    orig_plan = emb.sparse_plan
    monkeypatch.setattr(emb, "sparse_plan", lambda ids, *a, **kw: (
        shapes.append(tuple(ids.shape)), orig_plan(ids, *a, **kw))[1])
    takes = _counting(monkeypatch, ek, "take_rows_sum")
    bwd = [0]
    orig_bwd = ek.TakeRowsSum.backward

    def counted_bwd(ctx, g):
        bwd[0] += 1
        return orig_bwd(ctx, g)
    monkeypatch.setattr(ek.TakeRowsSum, "backward", staticmethod(counted_bwd))
    st, _ = tt.fit(tt.init_state(), _batches(8))
    assert shapes == [(4 * B, F)] * 2
    assert takes[0] == 2 * 2 and bwd[0] == 2 * 2
    assert st.step == 8 and _count(st) == 2


@pytest.mark.parametrize("layout,per_apply", [("fused", 1), ("dense", 4 * 2)])
def test_segment_sums_per_apply(monkeypatch, layout, per_apply):
    """The fused leg sums an apply's stacked view cotangents in ONE
    segment sum over a*B*F positions; the dense lookups sum theirs per
    microbatch and name (a position-order sum each, then added in
    microbatch order)."""
    tt = Trainer(Config(**_kw(grad_accum_steps=4, **LAYOUTS[layout])),
                 device="cpu")
    sizes = []
    orig = ek.segment_sum

    def counted(g, ids, num_slots, **kw):
        sizes.append(int(ids.numel()))
        return orig(g, ids, num_slots, **kw)
    monkeypatch.setattr(ek, "segment_sum", counted)
    tt.fit(tt.init_state(), _batches(8))
    assert len(sizes) == 2 * per_apply
    want = 4 * B * F if layout == "fused" else B * F
    assert set(sizes) == {want}


def test_accumulation_with_skip_guard_drops_the_whole_apply():
    """A NaN microbatch inside an accumulation group drops the dispatch's
    update; the clean dispatches still train, as a run without the
    poisoned group does, bit for bit."""
    kw = _kw(grad_accum_steps=2, on_nonfinite="skip", **LAYOUTS["hashed"])
    clean = _batches(8)
    poisoned = [dict(b) for b in clean[:4]]
    poisoned[1]["feat_vals"] = np.full_like(poisoned[1]["feat_vals"],
                                            np.nan)
    tt = Trainer(Config(**kw), device="cpu")
    guard = guard_lib.NonFiniteGuard.from_config(tt.cfg)
    st, out = tt.fit(tt.init_state(), poisoned + clean[4:], guard=guard)
    ref = Trainer(Config(**kw), device="cpu")
    rs, _ = ref.fit(ref.init_state(), clean[4:])
    assert out["steps"] == 4 and st.step == rs.step == 4
    assert guard.health.nonfinite_skips == 1
    _assert_bits(_snapshot(st), _snapshot(rs))


# ---------------------------------------------------------------------------
# Resume layout
# ---------------------------------------------------------------------------

def test_resume_layout_names_grad_accum_steps():
    """grad_accum_steps is part of the consumption layout, as in the JAX
    package's: a sidecar written under one accumulation regime does not
    resume mid-epoch under another (the epoch replays)."""
    a1 = Config(**_kw())
    a2 = Config(**_kw(grad_accum_steps=2))
    assert tasks._consumption_layout(a1)[-1] == 1
    assert tasks._consumption_layout(a2)[-1] == 2
    assert tasks._consumption_layout(a1) != tasks._consumption_layout(a2)
    jl = jax_tasks._consumption_layout(JaxConfig(**_kw(grad_accum_steps=2)))
    assert jl[-1] == tasks._consumption_layout(a2)[-1]


def test_resume_across_grad_accum_steps_replays_the_epoch(tmp_path):
    meta = {"step": 6, "epoch": 0, "steps_into_epoch": 6, "epoch_base": 0,
            "num_epochs": 2, "files": "digest", "completed": False}
    health = guard_lib.TrainHealth()
    for a, want in ((1, (0, 0, 6)), (2, (1, 0, 0))):
        cfg = Config(**_kw(model_dir=str(tmp_path), num_epochs=2))
        meta["layout"] = tasks._consumption_layout(cfg)
        tasks._write_resume_meta(str(tmp_path), meta)
        cfg_a = Config(**_kw(model_dir=str(tmp_path), num_epochs=2,
                             grad_accum_steps=a, steps_per_loop=4))
        assert tasks._resume_position(cfg_a, 6, "digest", health) == want
