"""The port's device-resident dataset (``Trainer.fit_device_resident``,
``--device_dataset``) on the CPU: its epoch indices equal the JAX
package's, its trajectory is bit-identical to the staged ``fit`` over the
same pipeline on the dense, sparse monolithic and hashed layouts (dropout
on), and within float32 tolerance of the JAX package's
``fit_device_resident`` from the same weights (dropout off); ``max_steps``,
the guard's skip, and the fallback reasons.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.data import cache as jax_cache
from deepfm_tpu.train import tasks as jax_tasks
from deepfm_tpu.train.loop import Trainer as JaxTrainer
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import cache as cache_lib
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.train import guard as guard_lib
from deepfm_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(1)

F, V = 6, 250
# float32: the same math summed in another order (tests/test_torch_train.py)
F32_LOSS_ATOL, F32_PARAM_ATOL = 1e-6, 2e-6

LAYOUTS = {
    "dense": {},
    "monolithic": {"embedding_update": "sparse"},
    "hashed": {"embedding_update": "sparse", "embedding_buckets": "97,131,61"},
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("dd")
    libsvm.generate_synthetic_ctr(str(d), num_files=2, examples_per_file=90,
                                  field_size=F, feature_size=V, seed=4,
                                  prefix="tr")
    return sorted(str(p) for p in d.glob("tr*.tfrecords"))


def _kw(**over):
    kw = dict(feature_size=V, field_size=F, embedding_size=8,
              deep_layers="16,8", dropout="0.5,0.5", batch_size=16,
              steps_per_loop=4, num_epochs=2, shuffle_buffer=1 << 20,
              learning_rate=0.01, log_steps=0, seed=21, mesh_data=1,
              mesh_model=1, decoded_cache="ram", compute_dtype="float32",
              scale_lr_by_world=False, drop_remainder=False)
    kw.update(over)
    return kw


def _train(cfg, files, max_steps=None, trainer=None):
    """The task driver's epochs: one pipeline and one fit per epoch."""
    cache_lib.clear_ram_cache()
    trainer = trainer or Trainer(cfg, device="cpu")
    state = trainer.init_state()
    losses = []
    hooks = [lambda s, m: losses.append((m["loss"].clone(),
                                         m["steps_done"]))]
    for epoch in range(cfg.num_epochs):
        pipe = tasks.make_pipeline(cfg, files, epoch_offset=epoch)
        if cfg.device_dataset:
            assert trainer.device_dataset_ineligible(pipe) is None
            state, fit_m = trainer.fit_device_resident(
                state, pipe, hooks=hooks, max_steps=max_steps)
        else:
            state, fit_m = trainer.fit(state, pipe, hooks=hooks,
                                       max_steps=max_steps)
    return state, losses, fit_m


@pytest.mark.parametrize("epoch,k,shuffle", [(0, 1, True), (3, 4, True),
                                             (1, 8, False)])
def test_device_epoch_indices_equal_jax(dataset, epoch, k, shuffle):
    cache_lib.clear_ram_cache()
    jax_cache.clear_ram_cache()
    cfg = Config(**_kw(steps_per_loop=k))
    pipe = tasks.make_pipeline(cfg, dataset, shuffle=shuffle)
    jpipe = jax_tasks.make_pipeline(JaxConfig(**_kw(steps_per_loop=k)),
                                    dataset, shuffle=shuffle)
    got = pipe.device_epoch_indices(epoch, k)
    np.testing.assert_array_equal(got, jpipe.device_epoch_indices(epoch, k))
    assert got.dtype == np.int32 and sorted(got) == list(range(180))
    # The gather of the indices is the staged emission of that epoch.
    cols = pipe.decoded_epoch_columns()
    pipe.epoch_offset = epoch
    pipe.prefetch_batches = 0
    emitted = np.concatenate([b["feat_ids"] for b in pipe])
    np.testing.assert_array_equal(cols.ids[got], emitted)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bit_identical_to_the_staged_fit(dataset, layout):
    """Same seed: the same per-dispatch losses and grouping, and
    bit-identical final params (the gather replays the pool's emission;
    the dropout generator advances step by step in both)."""
    kw = _kw(**LAYOUTS[layout])
    s_st, l_st, _ = _train(Config(**kw), dataset)
    s_dd, l_dd, fit_m = _train(Config(**kw, device_dataset=True), dataset)
    assert [n for _, n in l_st] == [n for _, n in l_dd] == \
        [4, 4, 1, 1, 1, 1] * 2
    for (a, _), (b, _) in zip(l_st, l_dd):
        assert torch.equal(a, b)
    assert s_st.step == s_dd.step == 24 and fit_m["steps"] == 12
    for key in s_st.params:
        assert torch.equal(s_st.params[key], s_dd.params[key]), key
    assert torch.equal(s_st.rng.get_state(), s_dd.rng.get_state())


@pytest.mark.parametrize("layout", ["dense", "monolithic"])
def test_matches_jax_fit_device_resident(dataset, layout):
    """JAX's init copied into the port, dropout off: the per-dispatch
    losses and the final params agree with JAX's ``fit_device_resident``
    within float32 tolerance."""
    kw = _kw(dropout="1.0,1.0", num_epochs=1, l2_reg=1e-3,
             device_dataset=True, **LAYOUTS[layout])
    jax_cache.clear_ram_cache()
    cache_lib.clear_ram_cache()
    jt = JaxTrainer(JaxConfig(**kw))
    js = jt.init_state()
    tt = Trainer(Config(**kw), device="cpu")
    ts = tt.load_weights(tt.init_state(), *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    jl, tl = [], []
    js, _ = jt.fit_device_resident(
        js, jax_tasks.make_pipeline(JaxConfig(**kw), dataset),
        hooks=[lambda s, m: jl.append(float(m["loss"]))])
    ts, _ = tt.fit_device_resident(
        ts, tasks.make_pipeline(Config(**kw), dataset),
        hooks=[lambda s, m: tl.append(float(m["loss"]))])
    assert len(jl) == len(tl) == 6
    np.testing.assert_allclose(tl, jl, rtol=0, atol=F32_LOSS_ATOL)
    want, _ = params_from_jax(jax.tree.map(np.asarray, js.params), {})
    assert set(want) == set(ts.params)
    for key, ref in want.items():
        np.testing.assert_allclose(ts.params[key].detach().numpy(),
                                   ref.numpy(), rtol=0, atol=F32_PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("max_steps", [3, 7])
def test_max_steps_truncation_matches_staged(dataset, max_steps):
    kw = _kw(num_epochs=1)
    _, l_st, m_st = _train(Config(**kw), dataset, max_steps=max_steps)
    _, l_dd, m_dd = _train(Config(**kw, device_dataset=True), dataset,
                           max_steps=max_steps)
    assert m_st["steps"] == m_dd["steps"] == float(max_steps)
    assert [n for _, n in l_st] == [n for _, n in l_dd]
    for (a, _), (b, _) in zip(l_st, l_dd):
        assert torch.equal(a, b)


def test_guard_skip_consumes_the_rows_as_staged(dataset, monkeypatch):
    """A dispatch the guard skips is undone, its rows consumed: the run
    ends bit-identical to the staged run that skips the same dispatch."""
    finals = []
    for dd in (False, True):
        cfg = Config(**_kw(num_epochs=1, on_nonfinite="skip",
                           device_dataset=dd))
        trainer = Trainer(cfg, device="cpu")
        calls = [0]

        def verdict(guard, state, m, calls=calls):
            calls[0] += 1
            return "skip" if calls[0] == 2 else "ok"

        monkeypatch.setattr(trainer, "_guard_verdict", verdict)
        cache_lib.clear_ram_cache()
        state = trainer.init_state()
        pipe = tasks.make_pipeline(cfg, dataset)
        fit = trainer.fit_device_resident if dd else trainer.fit
        state, out = fit(state, pipe, guard=guard_lib.NonFiniteGuard("skip"))
        assert out["steps"] == 12 - 4 and state.step == 8
        finals.append({k: v.clone() for k, v in state.params.items()})
    for key in finals[0]:
        assert torch.equal(finals[0][key], finals[1][key]), key


def test_ineligible_reasons(dataset):
    cache_lib.clear_ram_cache()
    trainer = Trainer(Config(**_kw(device_dataset=True)), device="cpu")
    pipe = tasks.make_pipeline(Config(**_kw(decoded_cache="off")), dataset)
    assert "no decoded cache" in trainer.device_dataset_ineligible(pipe)
    pipe = tasks.make_pipeline(Config(**_kw(shuffle_buffer=32)), dataset)
    assert "pool smaller" in trainer.device_dataset_ineligible(pipe)
    pipe = tasks.make_pipeline(Config(**_kw()), dataset, skip_batches=3)
    assert "skip_batches" in trainer.device_dataset_ineligible(pipe)
    pipe = tasks.make_pipeline(Config(**_kw()), dataset)
    assert trainer.device_dataset_ineligible(pipe) is None
    pipe = tasks.make_pipeline(Config(**_kw()), [dataset[0] + ".missing"])
    assert "decoded cache unavailable" in \
        trainer.device_dataset_ineligible(pipe)


def test_over_budget_warns_and_stages(dataset):
    cfg = Config(**_kw(device_dataset=True, num_epochs=1,
                       device_dataset_hbm_fraction=1e-9))
    cache_lib.clear_ram_cache()
    trainer = Trainer(cfg, device="cpu")
    assert trainer._device_memory_bytes() == 16 << 30  # the CPU assumption
    pipe = tasks.make_pipeline(cfg, dataset)
    assert "over the" in trainer.device_dataset_ineligible(pipe)
    with pytest.warns(RuntimeWarning, match="fell back to the staged"):
        state, fit_m = tasks._fit_epoch(trainer, cfg, trainer.init_state(),
                                        pipe, [], None)
    assert fit_m["steps"] == 12 and trainer._dd_cols is None
    with warnings.catch_warnings():  # eligible: no warning
        warnings.simplefilter("error", RuntimeWarning)
        cfg = cfg.replace(device_dataset_hbm_fraction=0.6)
        trainer = Trainer(cfg, device="cpu")
        tasks._fit_epoch(trainer, cfg, trainer.init_state(),
                         tasks.make_pipeline(cfg, dataset), [], None)
    assert trainer._dd_cols is not None  # the columns went to the device
