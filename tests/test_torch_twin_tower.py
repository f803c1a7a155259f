"""The port's twin tower (``models.twin_tower``) against the JAX package's,
on the CPU: the encoders and the item matrix from carried JAX weights
(within 1e-6), the in-batch softmax loss (within 1e-6 relative), its
gradients (within 1e-5), and a five-step Adam trajectory of
``train_twin_tower`` from the same init (tables within 1e-5), on the
monolithic and the hashed layout; then the empty-history, unit-norm and
input contracts.

The inputs are numpy batches made from a seed: ragged histories padded
with id 0 (some empty), random clicks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.models import twin_tower as jax_tt
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.models import get_model, registered_models
from deepfm_tpu_torch.models import twin_tower as tt
from deepfm_tpu_torch.utils.params import flatten, tower_params_from_jax

torch.set_num_threads(1)

V, F, K, L, B = 120, 5, 4, 6, 32
STEPS = 5
LAYOUTS = {"mono": {}, "hashed": dict(embedding_buckets="31,47,29")}
EMB_ATOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-5
TRAJ_ATOL = 1e-5


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="8", dropout="1.0", batch_size=B,
                compute_dtype="float32", mesh_data=1, log_steps=0, seed=3,
                scale_lr_by_world=False, model="din", history_max_len=L,
                learning_rate=1e-2)
    base.update(kw)
    return base


def _batches(n, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(0, L + 1, batch)
        lens[0] = 0
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
        out.append({
            "label": rng.integers(0, 2, (batch, 1)).astype(np.float32),
            "feat_ids": rng.integers(0, V, (batch, F)).astype(np.int32),
            "feat_vals": rng.normal(size=(batch, F)).astype(np.float32),
            "hist_ids": (rng.integers(0, V, (batch, L)) * mask
                         ).astype(np.int32),
            "hist_mask": mask})
    return out


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, tree)).items()}


def _pair(layout, seed=0):
    """(JAX model, JAX params of numpy leaves, port model carrying them)."""
    jmodel = jax_tt.TwinTower(JaxConfig(**_kw(**LAYOUTS[layout])))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    # Non-zero biases, so the carry-over of every leaf shows.
    rng = np.random.default_rng(seed + 1)
    for tower in ("user", "item"):
        for layer in params[tower]:
            layer["b"] = rng.normal(0, 0.1, layer["b"].shape).astype(
                np.float32)
    model = tt.TwinTower(Config(**_kw(**LAYOUTS[layout])), device="cpu")
    model.load_state_dict(tower_params_from_jax(params))
    return jmodel, params, model


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _loss_inputs(batch):
    w = ((batch["label"].reshape(-1) > 0)
         & (batch["hist_mask"].sum(axis=1) > 0)).astype(np.float32)
    return (batch["hist_ids"], batch["hist_mask"],
            np.ascontiguousarray(batch["feat_ids"][:, 0]), w)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_state_names_are_the_flattened_jax_tree(layout):
    _, params, model = _pair(layout)
    assert sorted(model.state_dict()) == sorted(flatten(params))
    assert "twin_tower" not in registered_models()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_encoders_match_jax(layout):
    jmodel, params, model = _pair(layout)
    b = _batches(1, seed=5)[0]
    ju = np.asarray(jmodel.user_embed(_jnp(params), b["hist_ids"],
                                      b["hist_mask"]))
    items = np.arange(V, dtype=np.int32)
    jv = np.asarray(jmodel.item_embed(_jnp(params), items))
    with torch.no_grad():
        pu = model.user_embed(torch.from_numpy(b["hist_ids"]),
                              torch.from_numpy(b["hist_mask"])).numpy()
        pv = model.item_embed(torch.from_numpy(items)).numpy()
    np.testing.assert_allclose(pu, ju, rtol=0, atol=EMB_ATOL)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=EMB_ATOL)
    # all_item_embeddings: batches of a size that does not divide V
    jall = jmodel.all_item_embeddings(_jnp(params), V, batch=50)
    pall = model.all_item_embeddings(V, batch=50)
    assert pall.dtype == np.float32 and pall.shape == (V, K)
    np.testing.assert_allclose(pall, jall, rtol=0, atol=EMB_ATOL)
    np.testing.assert_array_equal(pall, model.all_item_embeddings(V))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loss_and_gradients_match_jax(layout):
    jmodel, params, model = _pair(layout)
    inputs = _loss_inputs(_batches(1, seed=6)[0])
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        _jnp(params), *map(jnp.asarray, inputs))
    loss = model.loss(*map(torch.from_numpy, inputs))
    names = list(dict(model.named_parameters()))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    jg = _np_tree(jgrads)
    assert sorted(names) == sorted(jg)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)
        assert np.any(g.numpy() != 0), name


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_adam_trajectory_matches_jax(layout, monkeypatch):
    """Five steps of ``train_twin_tower`` in each package from one init
    (the JAX init of the same seed, carried into the port)."""
    cfg_kw = _kw(**LAYOUTS[layout])
    batches = _batches(STEPS, seed=7)
    jmodel, jparams, jstats = jax_tt.train_twin_tower(
        JaxConfig(**cfg_kw), batches, item_slot=0)
    init = tower_params_from_jax(jax.tree.map(
        np.asarray, jax_tt.TwinTower(JaxConfig(**cfg_kw)).init(
            jax.random.PRNGKey(cfg_kw["seed"]))))
    built = []
    cls = tt.TwinTower

    def carried(cfg, *, device, generator):
        assert generator.initial_seed() == cfg_kw["seed"]
        m = cls(cfg, device="meta")
        m.load_state_dict({k: v.clone() for k, v in init.items()},
                          assign=True)
        built.append(m)
        return m

    monkeypatch.setattr(tt, "TwinTower", carried)
    model, stats = tt.train_twin_tower(Config(**cfg_kw), batches,
                                       item_slot=0, device="cpu")
    assert model is built[0]
    assert stats["steps"] == jstats["steps"] == STEPS
    assert stats["positive_rows"] == jstats["positive_rows"] > 0
    np.testing.assert_allclose(stats["loss"], jstats["loss"], rtol=1e-5)
    assert np.isfinite(stats["first_loss"])
    want = _np_tree(jparams)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=TRAJ_ATOL, err_msg=name)
        assert not np.array_equal(got[name], init[name].numpy()), name


def test_train_twin_tower_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.train_twin_tower(Config(**_kw()), _batches(1))


def test_seeded_init_repeats():
    cfg = Config(**_kw())
    a = tt.TwinTower(cfg, device="cpu").state_dict()
    b = tt.TwinTower(cfg, device="cpu").state_dict()
    c = tt.TwinTower(cfg.replace(seed=4), device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["emb"], c["emb"])
    # pad rows of the monolithic table are zero, as in the JAX init
    assert a["emb"].shape[0] == 128 and not torch.any(a["emb"][V:])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_empty_history_is_finite_forward_and_backward(layout):
    """All-masked histories pool zeros: the user vector stays finite, and a
    zero-weighted empty-history row does not poison the gradient with NaN
    (the l2-normalize regression)."""
    _, _, model = _pair(layout)
    hist_ids = np.zeros((4, L), np.int32)
    hist_mask = np.zeros((4, L), np.float32)
    hist_ids[:2] = np.arange(1, L + 1)
    hist_mask[:2] = 1.0
    with torch.no_grad():
        u = model.user_embed(torch.zeros(2, L, dtype=torch.int32),
                             torch.zeros(2, L))
    assert torch.all(torch.isfinite(u))
    loss = model.loss(torch.from_numpy(hist_ids), torch.from_numpy(hist_mask),
                      torch.arange(4, dtype=torch.int32),
                      torch.tensor([1.0, 1.0, 0.0, 0.0]))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(bool(torch.all(torch.isfinite(g))) for g in grads)


def test_embeddings_are_unit_norm():
    _, _, model = _pair("mono")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, V, (8, L)).astype(np.int32))
    with torch.no_grad():
        u = model.user_embed(ids, torch.ones(8, L))
        v = model.item_embed(torch.arange(8, dtype=torch.int32))
    np.testing.assert_allclose(torch.linalg.norm(u, dim=1).numpy(), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(torch.linalg.norm(v, dim=1).numpy(), 1.0,
                               atol=1e-5)


def test_requires_history_batches():
    with pytest.raises(ValueError, match="history batches"):
        tt.train_twin_tower(Config(**_kw()), [{
            "label": np.zeros((4, 1), np.float32),
            "feat_ids": np.zeros((4, F), np.int32),
            "feat_vals": np.zeros((4, F), np.float32)}], device="cpu")


def test_not_a_zoo_member():
    with pytest.raises(ValueError, match="unknown model"):
        get_model(Config(**_kw(model="twin_tower")), device="cpu")
