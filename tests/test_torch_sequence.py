"""DIN and BST over the history input in the port against the JAX package,
on the CPU: ``masked_softmax`` (each of the JAX package's own checks, held
against its function), the target attention block, each model's eval
forward with and without a history, one step's gradients (``fm_v`` sums
the feature lookup's and the history lookup's cotangents), five-step
trajectories on the dense layouts the JAX config accepts with a history,
the history input (codec, native decode, pipelines), ``F + L``-wide
artifacts served through padded buckets and ``serve_latest``, and the
launcher's four tasks.

JAX weights (biases made non-zero) are carried into the port with
``params_from_jax``; dropout is off (keep 1.0).
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
from deepfm_tpu.models import sequence as jax_seq
from deepfm_tpu.native import loader as jax_loader
from deepfm_tpu.ops import fm as jax_fm
from deepfm_tpu.train import Trainer as JaxTrainer
from deepfm_tpu.utils import export as jax_export
from deepfm_tpu_torch import launch
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import example_codec, libsvm, tfrecord
from deepfm_tpu_torch.data import pipeline as pipe_lib
from deepfm_tpu_torch.models import get_model, sequence
from deepfm_tpu_torch.native import loader
from deepfm_tpu_torch.ops import fm as fm_ops
from deepfm_tpu_torch.serve import ServingEngine
from deepfm_tpu_torch.train import Trainer
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils.params import flatten, params_from_jax

torch.set_num_threads(1)

V, F, K, B, L = 500, 5, 8, 64, 6

# float32 / bfloat16 tolerances of tests/test_torch_model.py.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
# Five float32 Adam steps. The fm_v gradient is the sum of two segment sums
# that JAX adds as two scatter-adds in its own order: the DeepFM trajectory
# band holds (float32 reassociation only).
LOSS_ATOL, PARAM_ATOL = 1e-6, 2e-6
STEPS = 5
MODELS = ("din", "bst")
LAYOUTS = {"dense": {}, "dense_hashed": dict(embedding_buckets="97,131,61")}


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="1.0,1.0", batch_size=B,
                compute_dtype="float32", l2_reg=1e-3, learning_rate=5e-4,
                log_steps=0, seed=11, scale_lr_by_world=False, mesh_data=1,
                mesh_model=1, steps_per_loop=1, model="din",
                history_max_len=L)
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
        if name in ("b", "b1", "b2", "bn_bias", "fm_b", "mean"):
            return rng.normal(0, 0.2, x.shape).astype(np.float32)
        if name in ("bn_scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("pos", "target_pos"):
            return rng.normal(0, 0.3, x.shape).astype(np.float32)
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


def _inputs(n, seed=7, hist_len=L):
    """ids, vals, hist_ids, hist_mask: ragged histories of 0..hist_len real
    positions (some empty), padded with id 0 and mask 0."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (n, F)).astype(np.int32)
    vals = rng.normal(size=(n, F)).astype(np.float32)
    lens = rng.integers(0, hist_len + 1, n)
    lens[0] = 0
    mask = (np.arange(hist_len)[None, :] < lens[:, None]).astype(np.float32)
    hist = (rng.integers(0, V, (n, hist_len)) * mask).astype(np.int32)
    return ids, vals, hist, mask


def _batches(n, seed=0):
    out = []
    for i in range(n):
        ids, vals, hist, mask = _inputs(B, seed=seed + i)
        out.append({"label": np.random.default_rng(seed + i).integers(
            0, 2, (B, 1)).astype(np.float32), "feat_ids": ids,
            "feat_vals": vals, "hist_ids": hist, "hist_mask": mask})
    return out


def _jax_logits(jmodel, params, state, ids, vals, hist=None, mask=None):
    kw = {} if hist is None else dict(hist_ids=jnp.asarray(hist),
                                      hist_mask=jnp.asarray(mask))
    logits, _ = jmodel.apply(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jnp.asarray(ids), jnp.asarray(vals), train=False, **kw)
    return np.asarray(logits)


def _port_logits(model, ids, vals, hist=None, mask=None):
    kw = {} if hist is None else dict(hist_ids=torch.from_numpy(hist),
                                      hist_mask=torch.from_numpy(mask))
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(vals),
                     **kw).numpy()


# ---------------------------------------------------------------------------
# masked_softmax: the JAX package's checks (tests/test_sequence.py)
# ---------------------------------------------------------------------------

def _both_softmax(scores, mask):
    want = np.asarray(jax_fm.masked_softmax(jnp.asarray(scores),
                                            jnp.asarray(mask)))
    got = fm_ops.masked_softmax(torch.from_numpy(np.asarray(scores)),
                                torch.from_numpy(np.asarray(mask))).numpy()
    return got, want


@pytest.mark.parametrize("case", ["random", "full", "tail_masked",
                                  "broadcast_3d"])
def test_masked_softmax_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "random":
        scores = rng.normal(size=(6, 9)).astype(np.float32) * 3
        mask = (rng.random((6, 9)) < 0.6).astype(np.float32)
    elif case == "full":
        scores = rng.normal(size=(4, 7)).astype(np.float32)
        mask = np.ones((4, 7), np.float32)
    elif case == "tail_masked":
        scores = rng.normal(size=(5, 6)).astype(np.float32)
        mask = np.ones((5, 6), np.float32)
        mask[:, 4:] = 0.0
    else:  # BST: scores [B, M, L] against mask [B, 1, L]
        scores = rng.normal(size=(2, 3, 5)).astype(np.float32)
        mask = (rng.random((2, 1, 5)) < 0.5).astype(np.float32)
    got, want = _both_softmax(scores, mask)
    assert got.shape == want.shape == scores.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    valid_rows = np.broadcast_to(mask > 0, scores.shape).any(axis=-1)
    np.testing.assert_allclose(got.sum(axis=-1)[valid_rows], 1.0, rtol=1e-6)
    assert np.all(got[np.broadcast_to(mask, scores.shape) == 0] == 0.0)


def test_masked_softmax_all_masked_rows_are_exact_zeros():
    got, want = _both_softmax(np.asarray([[5.0, -3.0, 1.0], [0.0, 0.0, 0.0]],
                                         np.float32), np.zeros((2, 3),
                                                               np.float32))
    np.testing.assert_array_equal(got, np.zeros((2, 3)))
    np.testing.assert_array_equal(got, want)


def test_masked_softmax_extreme_scores_stay_finite():
    got, want = _both_softmax(np.asarray([[1e4, -1e4, 2.0]], np.float32),
                              np.asarray([[0.0, 0.0, 1.0]], np.float32))
    np.testing.assert_array_equal(got, [[0.0, 0.0, 1.0]])
    np.testing.assert_array_equal(got, want)


def test_masked_softmax_gradient_finite_through_all_masked_row():
    s = torch.tensor([[1.0, 2.0, 3.0], [0.5, -1.0, 2.0]],
                     requires_grad=True)
    mask = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 1.0]])
    w = torch.tensor([[1.0, 2.0, 3.0], [0.3, 0.2, -0.1]])
    torch.sum(fm_ops.masked_softmax(s, mask) * w).backward()
    want = jax.grad(lambda x: jnp.sum(jax_fm.masked_softmax(
        x, jnp.asarray(mask.numpy())) * jnp.asarray(w.numpy())))(
        jnp.asarray(s.detach().numpy()))
    assert torch.all(torch.isfinite(s.grad))
    np.testing.assert_array_equal(s.grad[0].numpy(), np.zeros(3))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# Target attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL),
                                               ("bfloat16", BF16_TOL)])
def test_target_attention_matches_jax(compute_dtype, tol):
    att = jax.tree.map(np.asarray, jax_seq.init_target_attention(
        jax.random.PRNGKey(0), K, 16))
    rng = np.random.default_rng(1)
    att["b1"] = rng.normal(0, 0.2, 16).astype(np.float32)
    att["b2"] = rng.normal(0, 0.2, 1).astype(np.float32)
    query = rng.normal(size=(9, K)).astype(np.float32)
    keys = rng.normal(size=(9, L, K)).astype(np.float32)
    mask = (rng.random((9, L)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    want = np.asarray(jax_seq.target_attention(
        jax.tree.map(jnp.asarray, att), jnp.asarray(query),
        jnp.asarray(keys), jnp.asarray(mask), jnp.dtype(compute_dtype)))
    mod = sequence.init_target_attention(
        K, 16, generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu"))
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in att.items()})
    with torch.no_grad():
        got = sequence.target_attention(
            mod, torch.from_numpy(query), torch.from_numpy(keys),
            torch.from_numpy(mask), getattr(torch, compute_dtype)).numpy()
    assert got.dtype == np.float32 and got.shape == (9, K)
    np.testing.assert_array_equal(got[0], np.zeros(K))
    np.testing.assert_allclose(got, want, **tol)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("batch_norm", [False, True])
def test_state_names_match_jax_tree(name, batch_norm):
    kw = dict(model=name, batch_norm=batch_norm)
    _, params, state = _jax_model(**kw)
    want = {k: v.shape for k, v in {**_np_tree(params),
                                    **_np_tree(state)}.items()}
    model = get_model(Config(**_kw(**kw)), device="cpu")
    assert model.uses_history is True
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL),
                                               ("bfloat16", BF16_TOL)])
def test_forward_matches_jax(name, batch_norm, compute_dtype, tol):
    """With ragged histories (row 0 empty) and with none at all (one
    all-masked position, bit-equal to an explicit empty history)."""
    kw = dict(model=name, batch_norm=batch_norm, compute_dtype=compute_dtype)
    jmodel, params, state = _jax_model(**kw)
    model = _port_model(params, state, **kw)
    ids, vals, hist, mask = _inputs(32)
    got = _port_logits(model, ids, vals, hist, mask)
    assert got.shape == (32,) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, _jax_logits(jmodel, params, state, ids, vals, hist, mask), **tol)
    none = _port_logits(model, ids, vals)
    np.testing.assert_allclose(
        none, _jax_logits(jmodel, params, state, ids, vals), **tol)
    np.testing.assert_array_equal(
        none, _port_logits(model, ids, vals, hist, np.zeros_like(mask)))
    assert not np.array_equal(none, got)


def test_bst_refuses_a_history_longer_than_its_position_table():
    _, params, state = _jax_model(model="bst")
    model = _port_model(params, state, model="bst")
    ids, vals, hist, mask = _inputs(4, hist_len=L + 1)
    with pytest.raises(ValueError, match="history_max_len"):
        _port_logits(model, ids, vals, hist, mask)
    assert model.att.pos.shape == (L, K)
    assert get_model(Config(**_kw(model="bst", history_max_len=0)),
                     device="cpu").att.pos.shape == (1, K)


def _pair(**kw):
    jt = JaxTrainer(JaxConfig(**_kw(**kw)))
    js = jt.init_state()
    tt = Trainer(Config(**_kw(**kw)), device="cpu")
    ts = tt.load_weights(tt.init_state(), *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    return jt, js, tt, ts


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step_grads_match_jax_grad(name, layout):
    """Mean BCE + l2: every gradient, ``fm_v``'s being the feature and the
    history lookups' segment sums added."""
    jt, js, tt, ts = _pair(model=name, **LAYOUTS[layout])
    b = _batches(1, seed=3)[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(params):
        logits, _ = jt.model.apply(params, js.model_state, jb["feat_ids"],
                                   jb["feat_vals"], train=True,
                                   **jt._hist_kwargs(jb))
        xent = jnp.mean(jt._per_example_loss(logits, jt._batch_labels(jb)))
        return xent + jt.model.l2_loss(params)

    jloss, jgrads = jax.value_and_grad(loss_fn)(js.params)
    loss, _, grads = tt.loss_and_grads(ts, tt.put_batch(b))
    assert abs(float(loss) - float(jloss)) < 1e-6
    want = _np_tree(jgrads)
    assert set(want) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_trajectory_matches_jax_trainer(name, layout):
    """Per-step loss and every param within the float32 band, except DIN's
    score bias ``att.b2``: the softmax is shift-invariant, so its gradient
    is zero up to float noise, which Adam's normalized step turns into
    moves of either sign on both sides; it is held to Adam's largest move
    over the run, STEPS * lr, from where it started."""
    jt, js, tt, ts = _pair(model=name, **LAYOUTS[layout])
    b2 = (np.asarray(js.params["att"]["b2"]).copy()
          if name == "din" else None)
    step = jt._make_train_step()
    jl, tl = [], []
    for b in _batches(STEPS):
        js, jm = step(js, jt.put_batch(b))
        ts, tm = tt.train_step(ts, tt.put_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    want = _np_tree(js.params)
    assert set(want) == set(ts.params)
    for k, v in ts.params.items():
        if k == "att.b2":
            lr = tt.cfg.learning_rate
            for moved in (v.detach().numpy(), want[k]):
                assert np.all(np.abs(moved - b2) <= STEPS * lr * 1.001)
            continue
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_config_keeps_the_history_refusals():
    """The config (a field-for-field copy) refuses a history with the
    sparse update, pipe mode, the device-resident dataset and multi-task."""
    for bad in (dict(embedding_update="sparse"), dict(pipe_mode=1),
                dict(device_dataset=True, decoded_cache="ram"),
                dict(tasks="ctr,cvr")):
        with pytest.raises(ValueError, match="history_max_len"):
            Config(**_kw(**bad)).validate()
    Config(**_kw()).validate()


# ---------------------------------------------------------------------------
# The history input
# ---------------------------------------------------------------------------

def _records(n, seed=0, max_hist=2 * L):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, max_hist + 1))
        hist = None if i % 7 == 3 else rng.integers(0, V, k)
        hv = None if hist is None or i % 2 else rng.random(k).astype(
            np.float32)
        out.append(example_codec.encode_ctr_example(
            float(rng.integers(0, 2)), rng.integers(0, V, F),
            rng.normal(size=F).astype(np.float32), hist_ids=hist,
            hist_vals=hv))
    return out


def test_history_codec_native_and_python_bit_equal_to_jax():
    """Records with no pair, an empty one, and ones longer than the column
    (truncated): encode bytes, the Python decode and the native decode."""
    recs = _records(60)
    rng = np.random.default_rng(3)
    hist = rng.integers(0, V, 4)
    vals = rng.random(F).astype(np.float32)
    assert example_codec.encode_ctr_example(
        1.0, np.arange(F), vals, hist_ids=hist) == \
        jax_codec.encode_ctr_example(1.0, np.arange(F), vals, hist_ids=hist)
    for rec in recs[:10]:
        for g, w in zip(example_codec.decode_ctr_example_hist(rec, F, L),
                        jax_codec.decode_ctr_example_hist(rec, F, L)):
            np.testing.assert_array_equal(g, w)
    want = jax_loader.decode_batch_hist(recs, F, L)
    assert want[5].max() == L and want[5].min() == 0
    for got in (loader.decode_batch_hist(recs, F, L),
                pipe_lib.decode_batch_hist_python(recs, F, L),
                jax_pipe.decode_batch_hist_python(recs, F, L)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert loader.has_hist()
    bad = example_codec.encode_example({
        "label": (np.ones(1, np.float32), "float"),
        "ids": (np.zeros(F, np.int64), "int64"),
        "values": (np.zeros(F, np.float32), "float"),
        "hist_ids": (np.zeros(3, np.int64), "int64"),
        "hist_vals": (np.zeros(2, np.float32), "float")})
    with pytest.raises(ValueError, match="hist"):
        loader.decode_batch_hist([bad], F, L)
    with pytest.raises(ValueError, match="history length"):
        example_codec.decode_ctr_example_hist(bad, F, L)


@pytest.fixture(scope="module")
def hist_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("hist")
    files = []
    for f in range(2):
        path = str(d / f"tr_{f}.tfrecords")
        with tfrecord.TFRecordWriter(path) as w:
            for rec in _records(300, seed=f):
                w.write(rec)
        files.append(path)
    return files


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_pipeline_history_columns_bit_equal_to_jax(hist_files, native,
                                                   shuffle):
    """``CtrPipeline(history=True)``: the pool packs ``feat_ids ||
    hist_ids`` and ``feat_vals || hist_mask`` and splits them at batch
    assembly; every column equals the JAX pipeline's, the k-step
    superbatches too."""
    kw = dict(field_size=F, batch_size=64, use_native_decoder=native,
              shuffle=shuffle, shuffle_buffer=150, drop_remainder=False,
              history=True, history_max_len=L, decoded_cache="ram")
    port = pipe_lib.CtrPipeline(hist_files, **kw)
    assert port.decoded_cache == "off" and not port.native_assembly
    got, want = list(port), list(jax_pipe.CtrPipeline(hist_files, **kw))
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["feat_ids", "feat_vals",
                                          "hist_ids", "hist_mask", "label"]
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if native:
        for (g, m, n), (w, mw, nw) in zip(
                pipe_lib.CtrPipeline(hist_files, **kw).iter_superbatches(4),
                jax_pipe.CtrPipeline(hist_files, **kw).iter_superbatches(4)):
            assert (m, n) == (mw, nw)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    with pytest.raises(ValueError, match="num_labels"):
        pipe_lib.CtrPipeline(hist_files, field_size=F, batch_size=4,
                             history=True, num_labels=2)


# ---------------------------------------------------------------------------
# Serving F + L wide artifacts
# ---------------------------------------------------------------------------

def _packed(n, seed):
    ids, vals, hist, mask = _inputs(n, seed=seed)
    return np.hstack([ids, hist]), np.hstack([vals, mask])


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("compute_dtype,tol", [
    ("float32", dict(rtol=1e-6, atol=1e-6)),
    ("bfloat16", dict(rtol=0, atol=2 ** -10))])
def test_artifact_is_f_plus_l_wide_and_padded_buckets_bit_equal(
        tmp_path, name, compute_dtype, tol):
    """``history_len`` L in ``model_config.json``, inputs F + L wide (ids
    ``feat_ids || hist_ids``, vals ``feat_vals || hist_mask``); the served
    probabilities match the JAX serving function on the same weights, and
    a padded bucket's real rows (zero padding: empty histories) equal the
    unpadded call bit for bit."""
    kw = dict(model=name, compute_dtype=compute_dtype)
    jmodel, params, state = _jax_model(**kw)
    jserve = jax.jit(jax_export._serving_fn(jmodel, JaxConfig(**_kw(**kw))))
    out = export_lib.export_serving(_port_model(params, state, **kw),
                                    Config(**_kw(**kw)), str(tmp_path / "1"))
    with open(os.path.join(out, "model_config.json")) as f:
        meta = json.load(f)
    assert meta["history_len"] == L
    assert meta["signature"]["inputs"]["feat_ids"] == ["batch", F + L,
                                                       "int32"]
    raw = export_lib.load_serving(out, device="cpu")
    bucketed = export_lib.load_serving(out, buckets=(1, 4, 16), device="cpu")
    assert bucketed.input_cols == F + L
    for n in (1, 2, 3, 7, 16):
        ids, vals = _packed(n, seed=n)
        got = bucketed(ids, vals)
        np.testing.assert_array_equal(got, raw(ids, vals))
        np.testing.assert_allclose(got, np.asarray(jserve(params, state, ids,
                                                          vals)), **tol)


def test_served_history_split_hands_the_fm_kernel_contiguous_rows(
        tmp_path, monkeypatch):
    """The packed columns split back into features and history before the
    forward; the CUDA FM kernel takes contiguous inputs only, so the split
    must hand it contiguous tensors (a strided view of the packed array
    would raise on the card, where the CPU's plain version would not)."""
    from deepfm_tpu_torch.models import graph
    seen = []
    fused = graph.fused_fm

    def checked(w, vals, xv):
        seen.append(all(t.is_contiguous() for t in (w, vals, xv)))
        return fused(w, vals, xv)

    monkeypatch.setattr(graph, "fused_fm", checked)
    _, params, state = _jax_model()
    out = export_lib.export_serving(_port_model(params, state),
                                    Config(**_kw()), str(tmp_path / "1"))
    ids, vals = _packed(5, seed=4)
    export_lib.load_serving(out, device="cpu")(ids, vals)
    assert seen == [True]


def test_serve_latest_serves_history_artifacts(tmp_path):
    """Two DIN versions behind ``LATEST``: the engine warms every bucket at
    F + L columns, answers with the artifact's own function, and hot-swaps."""
    publish = str(tmp_path)
    fns = []
    for version, seed in (("1", 0), ("2", 5)):
        _, params, state = _jax_model(seed=seed)
        export_lib.export_serving(_port_model(params, state), Config(**_kw()),
                                  os.path.join(publish, version))
        fns.append(export_lib.load_serving(os.path.join(publish, version),
                                           device="cpu"))
    export_lib.write_latest(publish, "1")
    buckets = export_lib.serving_buckets(8)
    eng = ServingEngine.serve_latest(
        publish, max_batch=8, max_delay_ms=1, watcher_kw={
            "loader": lambda p: export_lib.load_serving(
                p, buckets=buckets, device="cpu"), "start": False})
    try:
        assert eng.watcher.prewarmed_buckets == len(buckets)
        ids, vals = _packed(3, seed=9)
        np.testing.assert_array_equal(eng.predict(ids, vals, timeout=30),
                                      fns[0](ids, vals))
        export_lib.write_latest(publish, "2")
        assert eng.watcher.check_once()
        np.testing.assert_array_equal(eng.predict(ids, vals, timeout=30),
                                      fns[1](ids, vals))
        assert eng.stats.summary()["serving_failed"] == 0
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("seq_data"))
    for prefix, n, seed in (("tr", 640, 0), ("va", 256, 1), ("te", 100, 2)):
        libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=n,
                                      feature_size=V, field_size=F,
                                      prefix=prefix, seed=seed,
                                      history=2 * L)
    return d


@pytest.mark.parametrize("name", MODELS)
def test_launch_train_eval_infer_export(data_dir, tmp_path, name):
    """``--model <name> --history_max_len L`` on records with ragged
    histories of 0..2L ids: the four tasks run, infer reads the records'
    history (its predictions equal the artifact's on the packed columns of
    the same records), and the artifact is F + L wide."""
    flags = ["--feature_size", str(V), "--field_size", str(F),
             "--embedding_size", str(K), "--deep_layers", "16,8",
             "--batch_size", "64", "--learning_rate", "0.01",
             "--num_epochs", "1", "--data_dir", data_dir,
             "--val_data_dir", data_dir, "--model_dir",
             str(tmp_path / "ckpt"), "--servable_model_dir",
             str(tmp_path / "sv"), "--model", name, "--history_max_len",
             str(L)]
    for task in ("train", "eval", "infer", "export"):
        assert launch.main(["--task_type", task] + flags, device="cpu") == 0
    with open(os.path.join(data_dir, "pred.txt")) as f:
        preds = np.array([float(x) for x in f.read().split()])
    art = os.path.join(str(tmp_path / "sv"), "10")
    with open(os.path.join(art, "model_config.json")) as f:
        assert json.load(f)["history_len"] == L
    te = [p for p in os.listdir(data_dir) if p.startswith("te")]
    batch = next(iter(pipe_lib.CtrPipeline(
        [os.path.join(data_dir, te[0])], field_size=F, batch_size=100,
        shuffle=False, drop_remainder=False, history=True,
        history_max_len=L)))
    served = export_lib.load_serving(art, device="cpu")(
        np.hstack([batch["feat_ids"], batch["hist_ids"]]),
        np.hstack([batch["feat_vals"], batch["hist_mask"]]))
    assert preds.shape == (100,)
    np.testing.assert_allclose(preds, served, rtol=0, atol=1e-6)
