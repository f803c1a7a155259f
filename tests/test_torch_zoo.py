"""Wide&Deep, DCN-v2 and DLRM in the port against the JAX package, on the
CPU: the interaction blocks, each model's eval forward, one step's loss and
gradients, and short trajectories through the trainers on the dense,
sparse monolithic (fused and plan legs) and hashed layouts, padded serving
buckets, and the launcher's four tasks.

The JAX model is initialised by the JAX package; its params (biases made
non-zero) are carried into the port with ``params_from_jax``, and both
sides see the same numpy batches. Dropout is off (keep 1.0): the masks
cannot match across ``jax.random`` and ``torch.Generator``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.models import get_model as jax_get_model
from deepfm_tpu.models import graph as jax_graph
from deepfm_tpu.train import Trainer as JaxTrainer
from deepfm_tpu_torch import launch
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.models import get_model, graph
from deepfm_tpu_torch.train import Trainer
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils.params import (flatten, opt_state_from_jax,
                                           params_from_jax)

torch.set_num_threads(1)

V, F, K, B = 500, 6, 8, 64

# float32 towers: the same math, summed in another order.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 towers: a hidden unit can land one bf16 ulp (2^-8 relative)
# apart and carry that to the logit (tests/test_torch_model.py).
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
# Five float32 Adam steps at lr 5e-4 stay within the float32 band of the
# DeepFM trajectories (tests/test_torch_train.py, tests/test_torch_sparse.py).
LOSS_ATOL, PARAM_ATOL, M_ATOL, V_RTOL = 1e-6, 2e-6, 1e-7, 1e-5
STEPS = 5

MODELS = {
    "widedeep": dict(model="widedeep"),
    "dcnv2": dict(model="dcnv2"),
    "dcnv2_low_rank": dict(model="dcnv2", cross_rank=3, cross_layers=2),
    "dlrm": dict(model="dlrm"),
}
LAYOUTS = {
    "dense": {},
    "sparse_monolithic": dict(embedding_update="sparse"),
    "sparse_monolithic_off": dict(embedding_update="sparse",
                                  embedding_kernels="off"),
    "sparse_hashed": dict(embedding_update="sparse",
                          embedding_buckets="97,131,61"),
    "dense_hashed": dict(embedding_buckets="97,131,61"),
}


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="1.0,1.0", batch_size=B,
                compute_dtype="float32", l2_reg=1e-3, learning_rate=5e-4,
                log_steps=0, seed=11, scale_lr_by_world=False, mesh_data=1,
                mesh_model=1, steps_per_loop=1)
    base.update(kw)
    return base


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, tree)).items()}


def _perturb(params, state, seed):
    """Non-zero biases, BN affine params and running statistics (they start
    at 0 / 1 and would hide a wiring error)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", getattr(path[-1], "idx", "")))
        x = np.asarray(x)
        if name in ("b", "b1", "b2", "bn_bias", "fm_b", "mean"):
            return rng.normal(0, 0.2, x.shape).astype(np.float32)
        if name in ("bn_scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map_with_path(leaf, state))


def _jax_model(seed=0, **kw):
    jcfg = JaxConfig(**_kw(**kw))
    jmodel = jax_get_model(jcfg)
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


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"label": rng.integers(0, 2, (B, 1)).astype(np.float32),
             "feat_ids": rng.integers(0, V, (B, F)).astype(np.int32),
             "feat_vals": rng.standard_normal((B, F)).astype(np.float32)}
            for _ in range(n)]


def _jax_logits(jmodel, params, state, ids, vals, **kw):
    logits, _ = jmodel.apply(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jnp.asarray(ids), jnp.asarray(vals), train=False, **kw)
    return np.asarray(logits)


# ---------------------------------------------------------------------------
# Interaction blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 3])
@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL),
                                               ("bfloat16", BF16_TOL)])
def test_cross_network_matches_jax(rank, compute_dtype, tol):
    d = F * K
    keys = jax.random.split(jax.random.PRNGKey(rank), 3)
    jcross = [jax.tree.map(np.asarray, jax_graph.init_cross_layer(
        k, d, rank)) for k in keys]
    rng = np.random.default_rng(1)
    for layer in jcross:
        layer["b"] = rng.normal(0, 0.2, d).astype(np.float32)
    x0 = rng.normal(size=(16, d)).astype(np.float32)
    cdt = jnp.dtype(compute_dtype)
    want = jax_graph.cross_network(jax.tree.map(jnp.asarray, jcross),
                                   jnp.asarray(x0).astype(cdt), cdt)
    cross = torch.nn.ModuleList(graph.init_cross_layer(
        d, rank, generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu")) for _ in jcross)
    cross.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           flatten(jcross).items()})
    tdt = getattr(torch, compute_dtype)
    with torch.no_grad():
        got = graph.cross_network(cross, torch.from_numpy(x0).to(tdt))
    assert got.dtype == tdt and got.shape == (16, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_dot_interaction_matches_jax():
    """All F*(F-1)/2 pairwise dots in the JAX package's triangle order."""
    xv = np.random.default_rng(2).normal(size=(9, F, K)).astype(np.float32)
    want = np.asarray(jax_graph.dot_interaction(jnp.asarray(xv)))
    got = graph.dot_interaction(torch.from_numpy(xv)).numpy()
    assert got.shape == want.shape == (9, F * (F - 1) // 2)
    np.testing.assert_allclose(got, want, **F32_TOL)
    iu, ju = np.triu_indices(F, k=1)
    np.testing.assert_allclose(
        got, np.einsum("bik,bik->bi", xv[:, iu], xv[:, ju]), **F32_TOL)


# ---------------------------------------------------------------------------
# Models: names, eval forward, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("batch_norm", [False, True])
def test_state_names_match_jax_tree(name, batch_norm):
    kw = dict(MODELS[name], batch_norm=batch_norm)
    jmodel, params, state = _jax_model(**kw)
    want = {k: v.shape for k, v in {**_np_tree(params),
                                    **_np_tree(state)}.items()}
    got = {k: tuple(v.shape) for k, v in get_model(
        Config(**_kw(**kw)), device="cpu").state_dict().items()}
    assert got == want


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL),
                                               ("bfloat16", BF16_TOL)])
def test_forward_matches_jax(name, batch_norm, compute_dtype, tol):
    kw = dict(MODELS[name], batch_norm=batch_norm,
              compute_dtype=compute_dtype)
    jmodel, params, state = _jax_model(**kw)
    model = _port_model(params, state, **kw)
    ids, vals = _inputs(32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(vals)).numpy()
    assert got.dtype == np.float32 and got.shape == (32,)
    np.testing.assert_allclose(
        got, _jax_logits(jmodel, params, state, ids, vals), **tol)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("layout", ["dense", "dense_hashed"])
def test_step_grads_match_jax_grad(name, layout):
    """loss = mean BCE + l2 over the full tables, and every parameter's
    gradient (DCN-v2's ``fm_w`` and ``tower.out`` included: the l2 term's
    and zeros), in float32."""
    kw = dict(MODELS[name], **LAYOUTS[layout])
    jt = JaxTrainer(JaxConfig(**_kw(**kw)))
    js = jt.init_state()
    tt = Trainer(Config(**_kw(**kw)), device="cpu")
    ts = tt.load_weights(tt.init_state(), *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    b = _batches(1, seed=3)[0]

    def loss_fn(params):
        logits, _ = jt.model.apply(params, js.model_state,
                                   jnp.asarray(b["feat_ids"]),
                                   jnp.asarray(b["feat_vals"]), train=True)
        xent = jnp.mean(jt._per_example_loss(logits, jnp.asarray(
            b["label"][:, 0])))
        return xent + jt.model.l2_loss(params)

    jloss, jgrads = jax.value_and_grad(loss_fn)(js.params)
    loss, _, grads = tt.loss_and_grads(ts, tt.put_batch(b))
    assert abs(float(loss) - float(jloss)) < 1e-6
    want = _np_tree(jgrads)
    assert set(want) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_dcnv2_never_reads_fm_w():
    jmodel, params, state = _jax_model(model="dcnv2")
    model = _port_model(params, state, model="dcnv2")
    ids, vals = _inputs(8)
    with torch.no_grad():
        before = model(torch.from_numpy(ids), torch.from_numpy(vals))
        model.fm_w.mul_(3.0).add_(1.0)
        after = model(torch.from_numpy(ids), torch.from_numpy(vals))
    assert torch.equal(before, after)


# ---------------------------------------------------------------------------
# Trajectories through both trainers
# ---------------------------------------------------------------------------

def _pair(**kw):
    jt = JaxTrainer(JaxConfig(**_kw(**kw)))
    js = jt.init_state()
    tt = Trainer(Config(**_kw(**kw)), device="cpu")
    ts = tt.load_weights(tt.init_state(), *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    return jt, js, tt, ts


def run_both(jt, js, tt, ts, batches):
    step = jt._make_train_step()
    jl, tl = [], []
    for b in batches:
        js, jm = step(js, jt.put_batch(b))
        ts, tm = tt.train_step(ts, tt.put_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return js, ts, np.array(jl), np.array(tl)


def assert_state_matches(js, ts):
    """Params and model state within the float32 band; on the sparse
    update lazy Adam's m and v too, and tau and the counts exactly."""
    want = {**_np_tree(js.params), **_np_tree(js.model_state)}
    got = {k: v.detach().numpy() for k, v in {**ts.params,
                                               **ts.model_state}.items()}
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    if "embed" not in ts.opt_state:
        return
    je, te = js.opt_state["embed"], ts.opt_state["embed"]
    assert set(je) == set(te)
    for name in je:
        for key, e in je[name].items():
            t = te[name][key]
            np.testing.assert_array_equal(t.tau.numpy(), np.asarray(e.tau))
            np.testing.assert_allclose(t.m.numpy(), np.asarray(e.m), rtol=0,
                                       atol=M_ATOL)
            v = np.asarray(e.v)
            np.testing.assert_allclose(t.v.numpy(), v, rtol=0,
                                       atol=V_RTOL * max(np.abs(v).max(),
                                                         1e-30))
    assert ts.opt_state["count"] == int(js.opt_state["count"]) == ts.step


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_trajectory_matches_jax_trainer(name, layout):
    """Five float32 steps: per-step loss, params and (sparse) lazy-Adam
    state. DCN-v2's ``fm_w`` moves only by its l2 term, and its touched
    rows' tau advance as JAX's do."""
    kw = dict(MODELS[name], **LAYOUTS[layout])
    jt, js, tt, ts = _pair(**kw)
    js, ts, jl, tl = run_both(jt, js, tt, ts, _batches(STEPS))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    assert ts.step == int(js.step) == STEPS
    assert_state_matches(js, ts)


# Every zoo graph, its JAX checkpoint carried over mid-run: the multi-task
# heads (two-label batches) and the sequence models (history columns) too.
CARRIED = {
    "dcnv2": dict(model="dcnv2", batch_norm=True),
    "dcnv2_sparse": dict(model="dcnv2", embedding_update="sparse"),
    "dlrm": dict(model="dlrm"),
    "widedeep_hashed_sparse": dict(model="widedeep",
                                   embedding_update="sparse",
                                   embedding_buckets="97,131,61"),
    "mmoe": dict(tasks="ctr,cvr", multitask="mmoe", batch_norm=True),
    "esmm_sparse": dict(tasks="ctr,cvr", multitask="esmm",
                        embedding_update="sparse"),
    "din": dict(model="din", history_max_len=4),
    "bst": dict(model="bst", history_max_len=4),
}


def _carried_batches(n, kw, seed=5):
    out = _batches(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for b in out:
        if kw.get("tasks"):
            b["label2"] = b["label"] * rng.integers(0, 2, (B, 1)).astype(
                np.float32)
        if kw.get("history_max_len"):
            b["hist_mask"] = (rng.random((B, 4)) < 0.6).astype(np.float32)
            b["hist_ids"] = (rng.integers(0, V, (B, 4))
                             * b["hist_mask"]).astype(np.int32)
    return out


@pytest.mark.parametrize("name", sorted(CARRIED))
def test_jax_checkpoint_carried_into_port_continues_jax_trajectory(name):
    """Three JAX steps, then the JAX params, model state (BN buffers of the
    tower, experts or towers) and optimizer state carried into the port
    with ``params_from_jax`` and ``opt_state_from_jax``; the logits agree
    and three more steps on both sides stay in the float32 band."""
    kw = CARRIED[name]
    jt, js, tt, ts = _pair(**kw)
    step = jt._make_train_step()
    batches = _carried_batches(6, kw)
    for b in batches[:3]:
        js, _ = step(js, jt.put_batch(b))
    ts = tt.load_weights(ts, *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    ts.opt_state = opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state))
    ts.step = int(js.step)
    hist = {k: jnp.asarray(batches[3][k]) for k in ("hist_ids", "hist_mask")
            if k in batches[3]}
    want, _ = jt.model.apply(js.params, js.model_state,
                             jnp.asarray(batches[3]["feat_ids"]),
                             jnp.asarray(batches[3]["feat_vals"]),
                             train=False, **hist)
    with torch.no_grad():
        got = tt._logits(ts, tt.put_batch(batches[3]), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    js, ts, jl, tl = run_both(jt, js, tt, ts, batches[3:])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    want = _np_tree(js.params)
    for k, v in ts.params.items():
        # DIN's score bias: the softmax is shift-invariant, so its gradient
        # is float noise that Adam turns into moves of up to lr a step on
        # either side (tests/test_torch_sequence.py).
        atol = 2 * 3 * tt.cfg.learning_rate if k == "att.b2" else PARAM_ATOL
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# Serving and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_padded_buckets_return_unpadded_rows_bit_for_bit(tmp_path, name,
                                                         compute_dtype):
    """DCN-v2's combination head, like the tower's, is a row-wise dot: a
    padded bucket's real rows equal the unpadded call bit for bit."""
    kw = dict(MODELS[name], compute_dtype=compute_dtype)
    jmodel, params, state = _jax_model(**kw)
    cfg = Config(**_kw(**kw))
    out = export_lib.export_serving(_port_model(params, state, **kw), cfg,
                                    str(tmp_path / "1"))
    raw = export_lib.load_serving(out, device="cpu")
    bucketed = export_lib.load_serving(out, buckets=(1, 4, 16), device="cpu")
    for n in (1, 2, 3, 7, 16):
        ids, vals = _inputs(n, seed=n)
        np.testing.assert_array_equal(bucketed(ids, vals), raw(ids, vals))
    ids, vals = _inputs(16, seed=5)
    np.testing.assert_allclose(
        raw(ids, vals), 1 / (1 + np.exp(-_jax_logits(jmodel, params, state,
                                                     ids, vals))),
        **(F32_TOL if compute_dtype == "float32" else BF16_TOL))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("zoo_data"))
    for prefix, n, seed in (("tr", 640, 0), ("va", 256, 1), ("te", 100, 2)):
        libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=n,
                                      feature_size=V, field_size=F,
                                      prefix=prefix, seed=seed)
    return d


@pytest.mark.parametrize("name", sorted(MODELS))
def test_launch_train_eval_infer_export(data_dir, tmp_path, name):
    """The launcher's four tasks on the CPU: the trained checkpoint
    evaluates and infers, and its artifact serves what ``predict`` gives."""
    kw = MODELS[name]
    flags = ["--feature_size", str(V), "--field_size", str(F),
             "--embedding_size", str(K), "--deep_layers", "16,8",
             "--batch_size", "64", "--learning_rate", "0.01",
             "--num_epochs", "1", "--data_dir", data_dir,
             "--val_data_dir", data_dir, "--model_dir",
             str(tmp_path / "ckpt"), "--servable_model_dir",
             str(tmp_path / "sv"), "--model", kw["model"]]
    if "cross_rank" in kw:
        flags += ["--cross_rank", str(kw["cross_rank"]), "--cross_layers",
                  str(kw["cross_layers"])]
    for task in ("train", "eval", "infer", "export"):
        assert launch.main(["--task_type", task] + flags, device="cpu") == 0
    with open(os.path.join(data_dir, "pred.txt")) as f:
        preds = np.array([float(x) for x in f.read().split()])
    assert preds.shape == (100,) and np.all((preds > 0) & (preds < 1))
    art = os.path.join(str(tmp_path / "sv"), "10")
    with open(os.path.join(art, "model_config.json")) as f:
        meta = json.load(f)
    assert meta["model"] == kw["model"] and meta["history_len"] == 0
    assert meta["signature"]["outputs"] == {"prob": ["batch", "float32"]}
    ids, vals = _inputs(5)
    served = export_lib.load_serving(art, buckets=(1, 8), device="cpu")
    cfg = Config.from_dict(meta["config"])
    tt = Trainer(cfg, device="cpu")
    state = tt.load_weights(tt.init_state(), *(
        {k: v for k, v in torch.load(os.path.join(art, "params.pt"),
                                     weights_only=True).items()
         if k in names} for names in (
             dict(tt.init_state().params), dict(tt.init_state().model_state))))
    want = next(tt.predict(state, [{"feat_ids": ids, "feat_vals": vals,
                                    "label": np.zeros((5, 1), np.float32)}]))
    np.testing.assert_allclose(served(ids, vals), want, rtol=1e-6, atol=1e-7)
