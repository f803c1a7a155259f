"""The port's DeepFM eval forward against the JAX package's, on the CPU.

The JAX model is initialised with ``DeepFM(cfg).init``; its params are
carried into the port with ``params_from_jax`` and both forwards see the
same ids and values from a numpy seed. On the CPU the JAX side takes the
plain FM formula (``pallas_fm.supported`` is False there) and the port's
``fused_fm`` its plain version.
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
from deepfm_tpu.models import registered_models as jax_registered_models
from deepfm_tpu.ops import embedding as jax_emb
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.models import common, get_model, registered_models
from deepfm_tpu_torch.ops import embedding as emb
from deepfm_tpu_torch.utils import device as device_lib
from deepfm_tpu_torch.utils.params import flatten, params_from_jax

torch.set_num_threads(1)

V, F, K = 100, 5, 4

# float32 towers: the same math, summed in another order.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 towers: XLA and PyTorch round the bf16 products and bias adds at
# the same places, but accumulate in a different order, so a hidden unit
# can land one bf16 ulp (2^-8 relative) apart and carry that to the logit.
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)


def _cfg_kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="1.0,1.0", seed=3)
    base.update(kw)
    return base


def _jax_setup(seed=0, **kw):
    """JAX model + numpy params/state; BN (when on) gets non-trivial
    running statistics and affine params."""
    jcfg = JaxConfig(**_cfg_kw(**kw))
    jmodel = JaxDeepFM(jcfg)
    params, state = jmodel.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed + 1)
    # Bias vectors start at zero; make them count.
    for layer in params["tower"]["layers"]:
        layer["b"] = rng.normal(0, 0.1, layer["b"].shape).astype(np.float32)
        if "bn_scale" in layer:
            layer["bn_scale"] = rng.uniform(0.5, 1.5, layer["bn_scale"].shape
                                            ).astype(np.float32)
            layer["bn_bias"] = rng.normal(0, 0.2, layer["bn_bias"].shape
                                          ).astype(np.float32)
    params["fm_b"] = np.asarray([0.25], np.float32)
    for bn in state["bn"]:
        bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.2, 2.0, bn["var"].shape).astype(np.float32)
    return jcfg, jmodel, params, state


def _port_model(params, state, **kw):
    model = get_model(Config(**_cfg_kw(**kw)), device="cpu")
    p, s = params_from_jax(params, state)
    model.load_state_dict({**p, **s})
    return model


def _batch(n, seed=7, vocab=V):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, F)).astype(np.int32)
    vals = rng.normal(size=(n, F)).astype(np.float32)
    return ids, vals


def _jax_logits(jmodel, params, state, ids, vals):
    logits, _ = jmodel.apply(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jnp.asarray(ids), jnp.asarray(vals), train=False)
    return np.asarray(logits)


def _port_logits(model, ids, vals):
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(vals)).numpy()


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL),
                                               ("bfloat16", BF16_TOL)])
def test_forward_matches_jax(compute_dtype, tol, batch_norm):
    kw = dict(compute_dtype=compute_dtype, batch_norm=batch_norm)
    _, jmodel, params, state = _jax_setup(**kw)
    model = _port_model(params, state, **kw)
    ids, vals = _batch(32)
    got = _port_logits(model, ids, vals)
    assert got.dtype == np.float32 and got.shape == (32,)
    np.testing.assert_allclose(got, _jax_logits(jmodel, params, state,
                                                ids, vals), **tol)


def test_param_names_and_shapes_match_jax_tree():
    _, jmodel, params, state = _jax_setup(batch_norm=True)
    model = get_model(Config(**_cfg_kw(batch_norm=True)), device="cpu")
    want = {k: v.shape for k, v in {**flatten(params),
                                    **flatten(state)}.items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_init_pads_rows_with_zeros_and_draws_glorot():
    cfg = Config(**_cfg_kw(feature_size=1000, embedding_size=16))
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert model.fm_v.shape == (1024, 16)
    assert torch.all(model.fm_v[1000:] == 0) and torch.all(model.fm_w[1000:] == 0)
    std = (2.0 / (1000 + 16)) ** 0.5
    assert abs(float(model.fm_v[:1000].detach().std()) / std - 1) < 0.05
    limit = (6.0 / (F * 16 + 16)) ** 0.5
    w0 = model.tower.layers[0].w.detach()
    assert float(w0.abs().max()) <= limit and float(w0.abs().max()) > 0.9 * limit


def test_trainer_template_imports_no_dynamo():
    """The trainer builds its module on the meta device; the padded table
    must not go through a meta op whose kernel imports ``torch._dynamo``
    (seconds of every launcher process's start)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = ("import sys; from deepfm_tpu_torch.config import Config; "
              "from deepfm_tpu_torch.train import Trainer; "
              "t = Trainer(Config(feature_size=1000, field_size=5), "
              "device='cpu'); t.init_state(); "
              "print('torch._dynamo' in sys.modules)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


def test_generator_seeds_the_init():
    cfg = Config(**_cfg_kw())
    a = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    b = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    c = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    assert not torch.equal(a.fm_v, c.fm_v)


@pytest.mark.parametrize("shape", [(), (7,), (7, 3), (2, 5, 3)])
def test_fans_match_jax(shape):
    assert common._fans(shape) == jax_common._fans(shape)


def test_use_pallas_off_matches_on():
    _, _, params, state = _jax_setup()
    on = _port_model(params, state, use_pallas=True)
    off = _port_model(params, state, use_pallas=False)
    ids, vals = _batch(16)
    np.testing.assert_allclose(_port_logits(on, ids, vals),
                               _port_logits(off, ids, vals), **F32_TOL)


def test_training_mode_raises():
    """A training-mode forward with dropout needs a generator for its masks:
    without one it raises instead of training without dropout. With keep
    1.0, or with a generator, it runs."""
    ids, vals = (torch.from_numpy(a) for a in _batch(2))
    model = get_model(Config(**_cfg_kw(dropout="0.5,0.5")), device="cpu")
    model.train()
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        model(ids, vals)
    assert model(ids, vals, generator=torch.Generator().manual_seed(0)
                 ).shape == (2,)
    no_dropout = get_model(Config(**_cfg_kw()), device="cpu").train()
    assert no_dropout(ids, vals).shape == (2,)


@pytest.mark.parametrize("name", sorted(set(jax_registered_models())
                                        - {"deepfm"}))
def test_unported_models_raise(name):
    """Every model of the JAX registry is ported now: the port's registry
    holds the JAX one's and, beside it, only DLRM-DCNv2 (the port's own),
    and each name builds (none raises ``NotImplementedError``)."""
    assert set(jax_registered_models()) <= set(registered_models())
    assert set(registered_models()) - set(jax_registered_models()) == {
        "dlrm_dcnv2"}
    model = get_model(Config(**_cfg_kw(model=name)), device="cpu")
    assert model.name == name


def test_hashed_embeddings_not_ported():
    """Hash-bucketed tables are ported now: the model holds one table per
    bucket count under the JAX tree's names, and a multi-task model over
    them builds the same tables with one bias per task."""
    model = get_model(Config(**_cfg_kw(embedding_buckets="64,32")),
                      device="cpu")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
              if k.startswith("fm_")}
    assert shapes == {"fm_b": (1,), "fm_w.t0": (64,), "fm_w.t1": (32,),
                      "fm_v.t0": (64, K), "fm_v.t1": (32, K)}
    multi = get_model(Config(**_cfg_kw(embedding_buckets="64,32",
                                       tasks="ctr,cvr")), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in multi.state_dict().items()
              if k.startswith("fm_")}
    assert shapes == {"fm_b": (2,), "fm_w.t0": (64,), "fm_w.t1": (32,),
                      "fm_v.t0": (64, K), "fm_v.t1": (32, K)}


def test_missing_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(Config(**_cfg_kw()))
    assert device_lib.resolve("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# Embedding ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [1, 63, 64, 65, 1000, 117581])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_padded_vocab_matches_jax(vocab, shards):
    assert emb.padded_vocab(vocab, shards) == jax_emb.padded_vocab(vocab, shards)
    assert emb.padded_vocab(vocab, shards) % 64 == 0


def test_padded_vocab_reference_width():
    assert emb.padded_vocab(117581, 1) == 117632


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_lookup_out_of_range_matches_jnp_take(trailing):
    """jnp.take wraps ids in [-V, 0) and fills NaN for any other
    out-of-range id; index_select would hit a device-side assert."""
    v = 8
    rng = np.random.default_rng(0)
    table = rng.normal(size=(v, *trailing)).astype(np.float32)
    ids = np.array([[3, -1, v, -v], [-v - 1, 0, v - 1, 1000]], np.int32)
    got = emb.lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    assert got.shape == want.shape == (2, 4, *trailing)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_out_of_range_id_poisons_only_its_row():
    _, jmodel, params, state = _jax_setup()
    model = _port_model(params, state)
    ids, vals = _batch(4)
    ids[1, 2] = model.padded_vocab + 5
    got = _port_logits(model, ids, vals)
    want = _jax_logits(jmodel, params, state, ids, vals)
    np.testing.assert_array_equal(np.isnan(got), [False, True, False, False])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[[0, 2, 3]], want[[0, 2, 3]], **F32_TOL)
