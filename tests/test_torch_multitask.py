"""The multi-task heads (shared_bottom, MMoE, ESMM) in the port against the
JAX package, on the CPU: state names, the eval forward, the combined and
ESMM losses, one step's gradients, five-step trajectories on every layout
the JAX config accepts, the tier against the untiered run, the two-label
input (codec, native decode, pipelines), per-task eval and windowed AUC,
named serving outputs and the launcher's four tasks.

JAX weights (biases made non-zero) are carried into the port with
``params_from_jax``; dropout is off (keep 1.0). Labels are ``[B, 2]``:
task 0 reads ``label``, task 1 ``label2``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.data import example_codec as jax_codec
from deepfm_tpu.data import pipeline as jax_pipe
from deepfm_tpu.models import get_model as jax_get_model
from deepfm_tpu.native import loader as jax_loader
from deepfm_tpu.serve import ServingEngine as JaxServingEngine
from deepfm_tpu.train import Trainer as JaxTrainer
from deepfm_tpu.train import metrics as jax_metrics
from deepfm_tpu.utils import export as jax_export
from deepfm_tpu_torch import launch
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import example_codec, libsvm
from deepfm_tpu_torch.data import pipeline as pipe_lib
from deepfm_tpu_torch.data import tfrecord
from deepfm_tpu_torch.models import MultiTaskModel, get_model
from deepfm_tpu_torch.native import loader
from deepfm_tpu_torch.serve import ServingEngine
from deepfm_tpu_torch.train import Trainer, metrics
from deepfm_tpu_torch.train.loop import zero_batch
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils.params import flatten, params_from_jax

torch.set_num_threads(1)

V, F, K, B = 500, 6, 8, 64

# float32 / bfloat16 tolerances of tests/test_torch_model.py.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
# Five float32 Adam steps: the band of the DeepFM trajectories.
LOSS_ATOL, PARAM_ATOL, M_ATOL, V_RTOL = 1e-6, 2e-6, 1e-7, 1e-5
STEPS = 5
ARCHS = ("shared_bottom", "mmoe", "esmm")
LAYOUTS = {
    "dense": {},
    "sparse_monolithic": dict(embedding_update="sparse"),
    "sparse_monolithic_off": dict(embedding_update="sparse",
                                  embedding_kernels="off"),
    "sparse_hashed": dict(embedding_update="sparse",
                          embedding_buckets="97,131,61"),
}


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="1.0,1.0", batch_size=B,
                compute_dtype="float32", l2_reg=1e-3, learning_rate=5e-4,
                log_steps=0, seed=11, scale_lr_by_world=False, mesh_data=1,
                mesh_model=1, steps_per_loop=1, tasks="ctr,cvr",
                mmoe_experts=3, task_weights="1.0,0.5")
    base.update(kw)
    return base


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, tree)).items()}


def _perturb(params, state, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", getattr(path[-1], "idx", "")))
        x = np.asarray(x)
        if name in ("b", "bn_bias", "fm_b", "mean"):
            return rng.normal(0, 0.2, x.shape).astype(np.float32)
        if name in ("bn_scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map_with_path(leaf, state))


def _jax_model(seed=0, **kw):
    jmodel = jax_get_model(JaxConfig(**_kw(**kw)))
    params, state = jmodel.init(jax.random.PRNGKey(seed))
    params, state = _perturb(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), seed + 1)
    return jmodel, params, state


def _port_model(params, state, **kw):
    model = get_model(Config(**_kw(**kw)), device="cpu")
    p, s = params_from_jax(params, state)
    model.load_state_dict({**p, **s})
    return model


def _inputs(n, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (n, F)).astype(np.int32),
            rng.normal(size=(n, F)).astype(np.float32))


def _batches(n, seed=0, bs=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, 2, (bs, 1)).astype(np.float32)
        out.append({"label": y,
                    "label2": y * rng.integers(0, 2, (bs, 1)).astype(
                        np.float32),
                    "feat_ids": rng.integers(0, V, (bs, F)).astype(np.int32),
                    "feat_vals": rng.standard_normal((bs, F)).astype(
                        np.float32)})
    return out


def _jax_logits(jmodel, params, state, ids, vals):
    logits, _ = jmodel.apply(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jnp.asarray(ids), jnp.asarray(vals), train=False)
    return np.asarray(logits)


# ---------------------------------------------------------------------------
# Model: names, forward, losses, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch_norm", [False, True])
def test_state_names_match_jax_tree(arch, batch_norm):
    kw = dict(multitask=arch, batch_norm=batch_norm)
    _, params, state = _jax_model(**kw)
    want = {k: v.shape for k, v in {**_np_tree(params),
                                    **_np_tree(state)}.items()}
    model = get_model(Config(**_kw(**kw)), device="cpu")
    assert isinstance(model, MultiTaskModel)
    assert model.task_names == ("ctr", "cvr") and model.num_tasks == 2
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL),
                                               ("bfloat16", BF16_TOL)])
def test_forward_matches_jax(arch, batch_norm, compute_dtype, tol):
    kw = dict(multitask=arch, batch_norm=batch_norm,
              compute_dtype=compute_dtype)
    jmodel, params, state = _jax_model(**kw)
    model = _port_model(params, state, **kw)
    ids, vals = _inputs(32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(vals)).numpy()
    assert got.dtype == np.float32 and got.shape == (32, 2)
    np.testing.assert_allclose(
        got, _jax_logits(jmodel, params, state, ids, vals), **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loss_type", ["log_loss", "square_loss"])
def test_per_example_loss_matches_jax(arch, loss_type):
    """The weighted combination (ESMM: the entire-space pair, whatever the
    loss type), on logits up to +-30 so ESMM's pCTCVR clip engages."""
    kw = dict(multitask=arch, loss_type=loss_type)
    jmodel = jax_get_model(JaxConfig(**_kw(**kw)))
    model = get_model(Config(**_kw(**kw)), device="meta")
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(64, 2)) * rng.choice(
        [0.5, 5.0, 30.0], size=(64, 2))).astype(np.float32)
    labels = np.stack([rng.integers(0, 2, 64), rng.integers(0, 2, 64)],
                      axis=1).astype(np.float32)
    want = np.asarray(jmodel.per_example_loss(jnp.asarray(logits),
                                              jnp.asarray(labels)))
    got = model.per_example_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels)).numpy()
    assert got.shape == (64,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        model.probs_from_logits(torch.from_numpy(logits)).numpy(),
        np.asarray(jmodel.probs_from_logits(jnp.asarray(logits))))


def test_esmm_loss_term_for_term():
    """BCE(pCTR, y_ctr) + BCE(clip(pCTR * pCVR), y_ctr * y_cvr), each term
    weighted, against a float64 numpy oracle."""
    model = get_model(Config(**_kw(multitask="esmm")), device="meta")
    rng = np.random.default_rng(5)
    logits = rng.normal(scale=4.0, size=(200, 2)).astype(np.float32)
    logits[:4] = [[40, 40], [-40, 3], [3, -40], [0, 0]]
    labels = rng.integers(0, 2, (200, 2)).astype(np.float32)
    got = model.per_example_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels)).numpy()
    x = logits.astype(np.float64)
    p = 1 / (1 + np.exp(-x))
    y1, y2 = labels[:, 0], labels[:, 0] * labels[:, 1]
    l1 = np.logaddexp(0, -x[:, 0]) * y1 + np.logaddexp(0, x[:, 0]) * (1 - y1)
    pc = np.clip(p[:, 0] * p[:, 1], np.float32(1e-7), 1 - np.float32(1e-7))
    l2 = -(y2 * np.log(pc) + (1 - y2) * np.log1p(-pc))
    np.testing.assert_allclose(got, 1.0 * l1 + 0.5 * l2, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_grads_match_jax_grad(arch):
    """Mean combined loss + l2 over the full tables; every gradient."""
    kw = dict(multitask=arch)
    jt, js, tt, ts = _pair(**kw)
    b = _batches(1, seed=3)[0]

    def loss_fn(params):
        logits, _ = jt.model.apply(params, js.model_state,
                                   jnp.asarray(b["feat_ids"]),
                                   jnp.asarray(b["feat_vals"]), train=True)
        xent = jnp.mean(jt._per_example_loss(logits, jt._batch_labels(
            {k: jnp.asarray(v) for k, v in b.items()})))
        return xent + jt.model.l2_loss(params)

    jloss, jgrads = jax.value_and_grad(loss_fn)(js.params)
    loss, _, grads = tt.loss_and_grads(ts, tt.put_batch(b))
    assert abs(float(loss) - float(jloss)) < 1e-6
    want = _np_tree(jgrads)
    assert set(want) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Trajectories
# ---------------------------------------------------------------------------

def _pair(**kw):
    jt = JaxTrainer(JaxConfig(**_kw(**kw)))
    js = jt.init_state()
    tt = Trainer(Config(**_kw(**kw)), device="cpu")
    ts = tt.load_weights(tt.init_state(), *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    return jt, js, tt, ts


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_trajectory_matches_jax_trainer(arch, layout):
    """Five float32 steps on two-label batches: per-step loss, params,
    model state and (sparse) lazy-Adam state."""
    kw = dict(multitask=arch, batch_norm=arch == "mmoe", **LAYOUTS[layout])
    jt, js, tt, ts = _pair(**kw)
    step = jt._make_train_step()
    jl, tl = [], []
    for b in _batches(STEPS):
        js, jm = step(js, jt.put_batch(b))
        ts, tm = tt.train_step(ts, tt.put_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    want = {**_np_tree(js.params), **_np_tree(js.model_state)}
    got = {k: v.detach().numpy() for k, v in {**ts.params,
                                               **ts.model_state}.items()}
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    if "embed" in ts.opt_state:
        for name, tabs in js.opt_state["embed"].items():
            for key, e in tabs.items():
                t = ts.opt_state["embed"][name][key]
                np.testing.assert_array_equal(t.tau.numpy(),
                                              np.asarray(e.tau))
                np.testing.assert_allclose(t.m.numpy(), np.asarray(e.m),
                                           rtol=0, atol=M_ATOL)
                v = np.asarray(e.v)
                np.testing.assert_allclose(t.v.numpy(), v, rtol=0,
                                           atol=V_RTOL * np.abs(v).max())


def _fit_tables(**kw):
    tr = Trainer(Config(**_kw(**kw)), device="cpu")
    st, _ = tr.fit(tr.init_state(), _batches(8, bs=32))
    if tr._tier is not None:
        st = tr._tier.checkpoint_state(st)
    out = {k: v.detach().clone() for k, v in st.params.items()}
    for name, tabs in st.opt_state["embed"].items():
        for key, e in tabs.items():
            for f in e._fields:
                out[f"opt.{name}.{key}.{f}"] = getattr(e, f).clone()
    return out


@pytest.mark.parametrize("depth", [0, 2])
def test_tiered_multitask_bit_identical_to_untiered(depth):
    """The hot/cold tier under a multi-task graph (label2 rides the
    remapped batches): densified tables and slots equal the untiered sparse
    run's bit for bit."""
    kw = dict(multitask="mmoe", embedding_update="sparse", batch_size=32)
    want = _fit_tables(**kw)
    got = _fit_tables(embedding_tiering="hot_cold", embedding_hot_rows=256,
                      transfer_ahead=depth, **kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_device_dataset_names_a_multitask_run_ineligible():
    tr = Trainer(Config(**_kw(decoded_cache="ram")), device="cpu")
    assert "multi-task" in tr.device_dataset_ineligible(object())


def test_zero_batch_carries_label2_and_history():
    b = zero_batch(F, 4, num_labels=2)
    assert sorted(b) == ["feat_ids", "feat_vals", "label", "label2"]
    h = zero_batch(F, 4, hist_len=3)
    assert h["hist_ids"].shape == (4, 3) and h["hist_ids"].dtype == np.int32
    assert not h["hist_mask"].any() and "label2" not in h


# ---------------------------------------------------------------------------
# Eval, predict, windowed AUC
# ---------------------------------------------------------------------------

def test_evaluate_per_task_auc_matches_jax():
    """Per-task AUC (headline = the first task's) and the combined loss
    over a ragged tail, against the JAX trainer on the same weights."""
    jt, js, tt, ts = _pair(multitask="mmoe")
    batches = _batches(3, seed=8) + _batches(1, seed=9, bs=17)
    want = jt.evaluate(js, batches)
    got = tt.evaluate(ts, batches)
    for k in ("auc", "auc_ctr", "auc_cvr", "loss"):
        assert abs(got[k] - want[k]) < 1e-5, (k, got[k], want[k])
    assert got["auc"] == got["auc_ctr"]
    probs = list(tt.predict(ts, batches))
    assert [p.shape for p in probs] == [(B, 2)] * 3 + [(17, 2)]
    jprobs = list(jt.predict(js, batches))
    for p, q in zip(probs, jprobs):
        np.testing.assert_allclose(p, np.asarray(q), **F32_TOL)


def test_windowed_auc_dict_matches_jax():
    rng = np.random.default_rng(6)
    tasks = ("ctr", "cvr")
    jw = jax_metrics.WindowedAucDict(tasks, 10, num_bins=50)
    tw = metrics.WindowedAucDict(tasks, 10, num_bins=50)
    for step in (1, 4, 9, 13, 30):
        p = rng.random((40, 2))
        y = rng.integers(0, 2, (40, 2)).astype(np.float64)
        jw.update(step, p, y)
        tw.update(step, p, y)
        assert tw.examples == jw.examples
        got, want = tw.compute(), jw.compute()
        assert list(got) == list(tasks)
        for t in tasks:
            np.testing.assert_allclose(got[t], want[t], rtol=1e-6)
            h, hj = tw[t].histograms(), jw[t].histograms()
            np.testing.assert_array_equal(h[0], hj[0])
    one = metrics.WindowedAucDict(("ctr",), 5)
    one.update(1, rng.random(20), rng.integers(0, 2, 20))
    assert set(one.compute()) == {"ctr"}
    with pytest.raises(ValueError):
        metrics.WindowedAucDict((), 5)


def test_online_eval_folds_both_tasks_into_windows(data_dir, tmp_path):
    """The online trainer's evaluate with one window per task: per-task
    windowed AUC over ``predict``'s columns (the headline is the first
    task's) and the task-weighted mean of the clipped per-task log
    losses."""
    from deepfm_tpu_torch.train import tasks
    cfg = Config(**_kw(multitask="mmoe", val_data_dir=data_dir,
                       data_dir=data_dir))
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()
    window = metrics.WindowedAucDict(cfg.task_names, 5)
    va = tasks.resolve_files(data_dir, "va")
    ev = tasks._make_online_eval(tr, cfg, va, window, lambda s: 7)(state)
    batches = list(tasks._eval_pipeline(cfg, va))
    p = np.concatenate([pr[:len(b["label"])] for pr, b in zip(
        tr.predict(state, batches), batches)]).astype(np.float64)
    y = np.concatenate([np.hstack([b["label"], b["label2"]])
                        for b in batches]).astype(np.float64)
    want = metrics.WindowedAucDict(cfg.task_names, 5)
    want.update(7, p, y)
    for t in ("ctr", "cvr"):
        assert ev[f"auc_{t}"] == want.compute()[t]
    assert ev["auc"] == ev["auc_ctr"] and ev["window_examples"] == 256
    pc = np.clip(p, 1e-7, 1 - 1e-7)
    per_task = -(y * np.log(pc) + (1 - y) * np.log1p(-pc)).mean(axis=0)
    assert ev["loss"] == pytest.approx(1.0 * per_task[0] + 0.5 * per_task[1])


def test_pipe_mode_trains_on_the_two_label_stream(data_dir, tmp_path):
    """``--pipe_mode 1``: the streaming pipeline emits ``label2`` and the
    run reports per-task AUC."""
    from deepfm_tpu_torch.train import tasks
    res = tasks.run(Config(**_kw(
        multitask="esmm", pipe_mode=1, num_epochs=2, data_dir=data_dir,
        val_data_dir=data_dir, model_dir=str(tmp_path / "ckpt"))),
        device="cpu")
    assert res["steps"] == 2 * 640 // B
    assert {"auc_ctr", "auc_cvr"} <= set(res) and np.isfinite(res["loss"])


# ---------------------------------------------------------------------------
# Two-label input
# ---------------------------------------------------------------------------

def _records(n, seed=0, **kw):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        label2 = None if i % 5 == 4 else float(rng.integers(0, 2))
        out.append(example_codec.encode_ctr_example(
            float(rng.integers(0, 2)), rng.integers(0, V, F),
            rng.normal(size=F).astype(np.float32), label2=label2, **kw))
    return out


def test_two_label_codec_native_and_python_bit_equal_to_jax():
    """Encode bytes, the Python decode, the native decode (``label2`` 0.0
    where a record has none) and the batch decoders, bit for bit."""
    recs = _records(40)
    rng = np.random.default_rng(0)
    for i, rec in enumerate(recs[:5]):
        assert rec == jax_codec.encode_ctr_example(
            *example_codec.decode_ctr_example(rec, F),
            label2=None if i == 4 else example_codec.decode_ctr_example2(
                rec, F)[1])
        assert example_codec.decode_ctr_example2(rec, F)[:2] == \
            jax_codec.decode_ctr_example2(rec, F)[:2]
    assert example_codec.encode_ctr_example(1.0, [1, 2], [0.5, 0.5]) == \
        jax_codec.encode_ctr_example(1.0, [1, 2], [0.5, 0.5])
    want = jax_loader.decode_batch2(recs, F)
    for got in (loader.decode_batch2(recs, F),
                pipe_lib.decode_batch2_python(recs, F),
                jax_pipe.decode_batch2_python(recs, F)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert loader.has_labels2()
    bad = example_codec.encode_example({
        "label": (np.ones(1, np.float32), "float"),
        "label2": (np.ones(2, np.float32), "float"),
        "ids": (np.zeros(F, np.int64), "int64"),
        "values": (np.zeros(F, np.float32), "float")})
    with pytest.raises(ValueError, match="label2"):
        loader.decode_batch2([bad], F)
    with pytest.raises(ValueError, match="label2"):
        example_codec.decode_ctr_example2(bad, F)
    del rng


@pytest.fixture(scope="module")
def two_label_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("two_label")
    files = []
    for f in range(2):
        path = str(d / f"tr_{f}.tfrecords")
        with tfrecord.TFRecordWriter(path) as w:
            for rec in _records(300, seed=f):
                w.write(rec)
        files.append(path)
    return files


def _assert_emissions_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_pipeline_label2_column_bit_equal_to_jax(two_label_files, native,
                                                 shuffle):
    """``CtrPipeline(num_labels=2)``: the eager pooled path (the fused
    assembly and the input service are forced off) and the per-record
    path emit the JAX pipeline's batches, ``label2`` [B, 1] included; the
    k-step superbatches too."""
    kw = dict(field_size=F, batch_size=64, use_native_decoder=native,
              shuffle=shuffle, shuffle_buffer=150, drop_remainder=False,
              num_labels=2, input_workers=2, native_assembly=True)
    port = pipe_lib.CtrPipeline(two_label_files, **kw)
    assert port.input_workers == 0 and not port.native_assembly
    jax_kw = {k: v for k, v in kw.items() if k != "input_workers"}
    _assert_emissions_equal(list(port), list(jax_pipe.CtrPipeline(
        two_label_files, **jax_kw)))
    if native:
        got = [r for r, _, _ in pipe_lib.CtrPipeline(
            two_label_files, **kw).iter_superbatches(4)]
        want = [r for r, _, _ in jax_pipe.CtrPipeline(
            two_label_files, **jax_kw).iter_superbatches(4)]
        _assert_emissions_equal(got, want)


@pytest.mark.parametrize("native", [True, False])
def test_streaming_pipeline_label2_bit_equal_to_jax(two_label_files, native):
    kw = dict(field_size=F, batch_size=64, use_native_decoder=native,
              drop_remainder=False, num_labels=2)
    got = list(pipe_lib.StreamingCtrPipeline(
        pipe_lib.ChainedFileStream(two_label_files), **kw))
    want = list(jax_pipe.StreamingCtrPipeline(
        jax_pipe.ChainedFileStream(two_label_files), **kw))
    _assert_emissions_equal(got, want)
    with pytest.raises(ValueError, match="num_labels"):
        pipe_lib.StreamingCtrPipeline(pipe_lib.ChainedFileStream(
            two_label_files), field_size=F, batch_size=4, num_labels=3)


# ---------------------------------------------------------------------------
# Serving named outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compute_dtype,tol", [
    ("float32", dict(rtol=1e-6, atol=1e-6)),
    ("bfloat16", dict(rtol=0, atol=2 ** -10))])
def test_named_outputs_match_jax_and_padded_buckets_bit_equal(
        tmp_path, arch, compute_dtype, tol):
    """The artifact advertises ``{task: prob}`` in task order; the served
    dict matches the JAX serving function on the same weights, and a
    padded bucket's real rows equal the unpadded call bit for bit (the
    multi-task heads are row-wise dots)."""
    kw = dict(multitask=arch, compute_dtype=compute_dtype)
    jmodel, params, state = _jax_model(**kw)
    jserve = jax.jit(jax_export._serving_fn(jmodel, JaxConfig(**_kw(**kw))))
    cfg = Config(**_kw(**kw))
    out = export_lib.export_serving(_port_model(params, state, **kw), cfg,
                                    str(tmp_path / "1"))
    with open(os.path.join(out, "model_config.json")) as f:
        meta = json.load(f)
    assert list(meta["signature"]["outputs"]) == ["ctr", "cvr"]
    raw = export_lib.load_serving(out, device="cpu")
    bucketed = export_lib.load_serving(out, buckets=(1, 4, 16), device="cpu")
    for n in (1, 2, 3, 7, 16):
        ids, vals = _inputs(n, seed=n)
        got = bucketed(ids, vals)
        assert list(got) == ["ctr", "cvr"]
        for t, v in raw(ids, vals).items():
            np.testing.assert_array_equal(got[t], v)
        want = jserve(params, state, ids, vals)
        for t in ("ctr", "cvr"):
            np.testing.assert_allclose(got[t], np.asarray(want[t]), **tol)


def test_engine_demuxes_named_outputs_like_the_jax_engine(tmp_path):
    """Both engines over the same weights: every request resolves to
    ``{task: probs[n]}`` and the two agree."""
    kw = dict(multitask="esmm")
    jmodel, params, state = _jax_model(**kw)
    jserve = jax.jit(jax_export._serving_fn(jmodel, JaxConfig(**_kw(**kw))))
    out = export_lib.export_serving(_port_model(params, state, **kw),
                                    Config(**_kw(**kw)), str(tmp_path / "1"))
    fn = export_lib.load_serving(out, device="cpu")
    reqs = [_inputs(n, seed=20 + n) for n in (2, 5, 9)]
    results = []
    for eng in (ServingEngine(fn, max_batch=16, max_delay_ms=10_000,
                              start=False),
                JaxServingEngine(
                    lambda i, v: {k: np.asarray(x) for k, x in jserve(
                        params, state, i, v).items()},
                    max_batch=16, max_delay_ms=10_000, start=False)):
        futs = [eng.submit(ids, vals) for ids, vals in reqs]
        eng.start()
        eng.close(timeout=30)
        results.append([f.result(timeout=0) for f in futs])
    for got, want, (ids, _) in zip(*results, reqs):
        assert sorted(got) == sorted(want) == ["ctr", "cvr"]
        for t in got:
            assert got[t].shape == (ids.shape[0],)
            np.testing.assert_allclose(got[t], want[t], rtol=1e-6,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mt_data"))
    for prefix, n, seed in (("tr", 640, 0), ("va", 256, 1), ("te", 100, 2)):
        libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=n,
                                      feature_size=V, field_size=F,
                                      prefix=prefix, seed=seed, num_labels=2)
    return d


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_eval_infer_export(data_dir, tmp_path, arch):
    """``--tasks ctr,cvr --multitask <arch>``: train reports per-task AUC,
    eval too, infer writes two columns a line, the artifact serves named
    outputs equal to ``predict``'s columns."""
    flags = ["--feature_size", str(V), "--field_size", str(F),
             "--embedding_size", str(K), "--deep_layers", "16,8",
             "--batch_size", "64", "--learning_rate", "0.01",
             "--num_epochs", "1", "--data_dir", data_dir,
             "--val_data_dir", data_dir, "--model_dir",
             str(tmp_path / "ckpt"), "--servable_model_dir",
             str(tmp_path / "sv"), "--tasks", "ctr,cvr", "--multitask", arch,
             "--mmoe_experts", "3"]
    for task in ("train", "eval", "infer", "export"):
        assert launch.main(["--task_type", task] + flags, device="cpu") == 0
    with open(os.path.join(data_dir, "pred.txt")) as f:
        rows = [line.split() for line in f]
    assert len(rows) == 100 and all(len(r) == 2 for r in rows)
    art = os.path.join(str(tmp_path / "sv"), "10")
    with open(os.path.join(art, "model_config.json")) as f:
        meta = json.load(f)
    assert list(meta["signature"]["outputs"]) == ["ctr", "cvr"]
    res = Trainer(Config.from_dict(meta["config"]), device="cpu")
    served = export_lib.load_serving(art, buckets=(8,), device="cpu")
    ids, vals = _inputs(5)
    out = served(ids, vals)
    assert sorted(out) == ["ctr", "cvr"]
    weights = torch.load(os.path.join(art, "params.pt"), weights_only=True)
    state = res.init_state()
    res.load_weights(state, {k: weights[k] for k in state.params},
                     {k: weights[k] for k in state.model_state})
    want = next(res.predict(state, [{"feat_ids": ids, "feat_vals": vals,
                                     "label": np.zeros((5, 1), np.float32),
                                     "label2": np.zeros((5, 1),
                                                        np.float32)}]))
    np.testing.assert_allclose(out["ctr"], want[:, 0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out["cvr"], want[:, 1], rtol=1e-6, atol=1e-7)
