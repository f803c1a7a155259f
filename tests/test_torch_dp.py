"""The port's synchronous data parallelism (``torch.distributed``, gloo on
the CPU) against the JAX package's single-device Trainer on the global
batch.

Each multi-process case runs 2 or 4 rank processes of this file (its
``__main__`` entry) under a hard timeout, rendezvousing through a
``file://`` store in ``tmp_path``. The ranks run several scenarios in one
start-up; rank r trains on rows ``[r * B/N, (r + 1) * B/N)`` of every
global batch. The oracle is the JAX ``Trainer`` on one device over the
global batches, from the same JAX-initialized weights
(``params_from_jax``), with ``scale_lr_by_world`` off and dropout keep 1.0.

Tolerances (no looser than ``tests/test_trainer.py``'s DP parity): fm_b
rtol 5e-3 / atol 2e-4, every other param and the BN running statistics
rtol 1e-3 / atol 1e-5, the eval loss 1e-4 (BN: 1e-3, its JAX test's), the
AUC 5e-3. The ranks' params must be bit-identical to each other (one
replicated update), ``hierarchical_psum`` within 2 ulp of the flat
all_reduce, and ``auc_psum`` exact.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from deepfm_tpu_torch.config import Config  # noqa: E402
from deepfm_tpu_torch.parallel import bootstrap  # noqa: E402
from deepfm_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from deepfm_tpu_torch.train import Trainer  # noqa: E402
from deepfm_tpu_torch.train import guard as guard_lib  # noqa: E402
from deepfm_tpu_torch.train import metrics as metrics_lib  # noqa: E402
from deepfm_tpu_torch.train import optimizers as opt_lib  # noqa: E402

V, F, K, B, L = 3000, 10, 8, 64, 6
BUCKETS = "997,1311,613"
RANK_TIMEOUT_S = 150
FM_B_TOL = dict(rtol=5e-3, atol=2e-4)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
EVAL_LOSS_TOL, BN_EVAL_LOSS_TOL, AUC_TOL = 1e-4, 1e-3, 5e-3


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="1.0,1.0", batch_size=B,
                compute_dtype="float32", l2_reg=1e-3, learning_rate=5e-3,
                log_steps=0, seed=11, scale_lr_by_world=False,
                steps_per_loop=2, transfer_ahead=0, shuffle_buffer=100)
    base.update(kw)
    return base


# name -> (world sizes, config overrides, global batches, extra)
SCENARIOS = {
    "dense": ((2, 4), {}, 8, {}),
    "hashed": ((2, 4), dict(embedding_buckets=BUCKETS), 8, {}),
    "bn": ((2,), dict(batch_norm=True), 8, {}),
    "din": ((2,), dict(model="din", history_max_len=L), 6, {}),
    "accum": ((2,), dict(grad_accum_steps=2, steps_per_loop=4), 8, {}),
    "sparse": ((2,), dict(embedding_update="sparse"), 6, {}),
    "ragged": ((2,), {}, 5, {"ragged": [5, 3], "eval_ragged": [3, 1]}),
    "hier": ((4,), {}, 8, {"hier": [[[0, 1], [2, 3]], [[0, 2], [1, 3]]],
                           "data": "dense"}),
    # A NaN in rank 1's rows of global batch 2: the pmean'd loss is NaN on
    # every rank, so every rank skips the same dispatch.
    "skip": ((2,), dict(on_nonfinite="skip"), 6, {"poison": [1, 2]}),
    # Dropout on: each rank draws its own masks; no single-device oracle.
    "dropout": ((2,), dict(dropout="0.5,0.5"), 4, {"no_oracle": True}),
}
JAX_KW = {"sparse": dict(embedding_update="dense")}


def _batches(n, seed, bs=B, hist=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"label": rng.integers(0, 2, (bs, 1)).astype(np.float32),
             "feat_ids": rng.integers(0, V, (bs, F)).astype(np.int32),
             "feat_vals": rng.standard_normal((bs, F)).astype(np.float32)}
        if hist:
            lens = rng.integers(0, L + 1, bs)
            mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
            b["hist_ids"] = (rng.integers(0, V, (bs, L)) * mask).astype(
                np.int32)
            b["hist_mask"] = mask
        out.append(b)
    return out


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _unstack(d):
    n = d["label"].shape[0]
    return [{k: d[k][i] for k in d} for i in range(n)]


# ---------------------------------------------------------------------------
# The rank processes
# ---------------------------------------------------------------------------

def _rank_scenario(sc, world, rank, out_dir):
    cfg = Config(**sc["cfg"])
    tr = Trainer(cfg, device="cpu")
    if sc.get("hier"):
        tr._hier_groups = tuple(sc["hier"])
    w = np.load(sc["weights"])
    params = {k[2:]: torch.from_numpy(w[k]) for k in w.files
              if k.startswith("p.")}
    mstate = {k[2:]: torch.from_numpy(w[k]) for k in w.files
              if k.startswith("s.")}
    state = tr.load_weights(tr.init_state(), params, mstate)
    local = B // world
    glob = _unstack(dict(np.load(sc["batches"])))
    n = sc["ragged"][rank] if sc.get("ragged") else len(glob)
    mine = [{k: v[rank * local:(rank + 1) * local] for k, v in b.items()}
            for b in glob[:n]]
    losses = []
    guard = (guard_lib.NonFiniteGuard.from_config(cfg)
             if cfg.on_nonfinite != "abort" else None)
    state, out = tr.fit(state, mine, guard=guard, hooks=[
        lambda s, m: losses.append(float(m["loss"]))])
    ev_glob = _unstack(dict(np.load(sc["eval"])))
    n_ev = sc["eval_ragged"][rank] if sc.get("eval_ragged") else len(ev_glob)
    ev_mine = [{k: v[rank * local:(rank + 1) * local] for k, v in b.items()
                if k != "weight"} for b in ev_glob[:n_ev]]
    if n_ev and sc.get("eval_ragged"):
        ev_mine[-1] = {k: v[:local // 2 + rank] for k, v in
                       ev_mine[-1].items()}
    ev = tr.evaluate(state, ev_mine)
    res = {"fit": {k: v for k, v in out.items()
                   if isinstance(v, (int, float, str))},
           "eval": ev, "losses": losses, "step": int(state.step),
           "sparse_embed": tr.sparse_embed,
           "strategy": out.get("collective_strategy")}
    arrays = {f"p.{k}": v.detach().numpy() for k, v in state.params.items()}
    arrays.update({f"s.{k}": v.numpy() for k, v in state.model_state.items()})
    np.savez(os.path.join(out_dir, f"{sc['name']}.{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"{sc['name']}.{rank}.json"), "w") as f:
        json.dump(res, f)


def _rank_collectives(world, rank, out_dir):
    """auc_psum of per-rank histograms, and hierarchical vs flat sums."""
    rng = np.random.default_rng(100 + rank)
    probs = torch.from_numpy(rng.random(200).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 2, 200).astype(np.float32))
    st = metrics_lib.auc_update(metrics_lib.auc_init(50), probs, labels)
    summed = metrics_lib.auc_psum(st)
    x = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32))
    flat = x.clone()
    torch.distributed.all_reduce(flat)
    scale = x.abs()
    torch.distributed.all_reduce(scale)
    arrays = {"pos": summed.pos.numpy(), "neg": summed.neg.numpy(),
              "flat": flat.numpy(), "scale": scale.numpy()}
    if world == 4:
        groups = ([[0, 1], [2, 3]], [[0, 2], [1, 3]])
        arrays["hier"] = mesh_lib.hierarchical_psum(
            [x.clone()], groups)[0].numpy()
        arrays["hier_mean"] = mesh_lib.hierarchical_pmean(
            [x.clone()], groups, world)[0].numpy()
    np.savez(os.path.join(out_dir, f"collectives.{rank}.npz"), **arrays)


def _rank_main(spec_path, rank):
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    bootstrap.initialize(Config(
        dist_mode=1, num_processes=world, process_id=rank,
        coordinator_address="file://" + spec["store"]), device="cpu")
    assert bootstrap.process_count() == world
    _rank_collectives(world, rank, spec["out"])
    for sc in spec["scenarios"]:
        _rank_scenario(sc, world, rank, spec["out"])
    bootstrap.barrier()
    bootstrap.destroy()


def run_ranks(world, spec, tmp, timeout=RANK_TIMEOUT_S, script=None):
    """Run ``world`` rank processes of ``script`` (default: this file) on
    ``spec``, as ``script <spec.json> <rank>``; one failure (or the
    timeout) kills the others and fails with their output."""
    spec = {**spec, "world": world, "store": str(tmp / "store"),
            "out": str(tmp)}
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           bootstrap.TIMEOUT_ENV: "60"}
    procs = [subprocess.Popen(
        [sys.executable, script or os.path.abspath(__file__), str(path),
         str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.time() + timeout
    failed = None
    while any(p.poll() is None for p in procs):
        if time.time() > deadline or any(p.poll() not in (None, 0)
                                         for p in procs):
            failed = "timeout" if time.time() > deadline else "rank failed"
            break
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
    logs = [p.communicate()[0] for p in procs]
    if failed or any(p.returncode for p in procs):
        raise AssertionError(f"{failed or 'rank failed'}: "
                             + "\n".join(logs)[-6000:])
    return logs


# ---------------------------------------------------------------------------
# The oracle and the runs
# ---------------------------------------------------------------------------

def _jax():
    import jax  # noqa: PLC0415
    from deepfm_tpu.config import Config as JaxConfig  # noqa: PLC0415
    from deepfm_tpu.train import Trainer as JaxTrainer  # noqa: PLC0415
    from deepfm_tpu_torch.utils.params import (  # noqa: PLC0415
        flatten, params_from_jax)
    return jax, JaxConfig, JaxTrainer, flatten, params_from_jax


def _np_tree(jax, flatten, tree):
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, tree)).items()}


def _prepare(world, tmp):
    """Weights, batches and the JAX single-device result per scenario."""
    jax, JaxConfig, JaxTrainer, flatten, params_from_jax = _jax()
    scenarios, want = [], {}
    names = list(SCENARIOS)
    for name, (worlds, over, n, extra) in SCENARIOS.items():
        if world not in worlds:
            continue
        i = names.index(extra.get("data", name))
        kw = _kw(**over)
        jt = JaxTrainer(JaxConfig(**{**kw, **JAX_KW.get(name, {}),
                                     "mesh_data": 1, "mesh_model": 1}))
        js = jt.init_state()
        p, s = params_from_jax(jax.tree.map(np.asarray, js.params),
                               jax.tree.map(np.asarray, js.model_state))
        wpath = tmp / f"{name}.weights.npz"
        np.savez(wpath, **{f"p.{k}": v.numpy() for k, v in p.items()},
                 **{f"s.{k}": v.numpy() for k, v in s.items()})
        hist = over.get("history_max_len", 0) > 0
        glob = _batches(n, seed=10 + i, hist=hist)
        if "poison" in extra:
            r, b = extra["poison"]
            glob[b]["feat_vals"][r * (B // world)] = np.nan
        ev = _batches(3, seed=50 + i, hist=hist)
        np.savez(tmp / f"{name}.batches.npz", **_stack(glob))
        np.savez(tmp / f"{name}.eval.npz", **_stack(ev))
        local = B // world
        steps = n
        ev_used = ev
        if "ragged" in extra:
            steps = min(extra["ragged"])
            ev_used = []
            for r, n_ev in enumerate(extra["eval_ragged"]):
                part = [{k: v[r * local:(r + 1) * local] for k, v in b.items()}
                        for b in ev[:n_ev]]
                part[-1] = {k: v[:local // 2 + r] for k, v in part[-1].items()}
                ev_used += part
        want[name] = {"steps": steps}
        if "poison" in extra:  # one dispatch of steps_per_loop skipped
            want[name]["steps"] = steps - kw["steps_per_loop"]
        if not extra.get("no_oracle"):
            from deepfm_tpu.train import guard as jax_guard  # noqa: PLC0415
            jguard = (jax_guard.NonFiniteGuard.from_config(JaxConfig(**kw))
                      if kw.get("on_nonfinite", "abort") != "abort"
                      else None)
            js, jo = jt.fit(js, iter(glob[:steps]), guard=jguard)
            jev = jt.evaluate(js, iter(ev_used))
            want[name].update(params=_np_tree(jax, flatten, js.params),
                              state=_np_tree(jax, flatten, js.model_state),
                              eval=jev)
        scenarios.append({"name": name, "cfg": kw, "weights": str(wpath),
                          "batches": str(tmp / f"{name}.batches.npz"),
                          "eval": str(tmp / f"{name}.eval.npz"), **extra})
    return scenarios, want


def _results(world, tmp, names):
    out = {}
    for name in names:
        ranks = []
        for r in range(world):
            arr = dict(np.load(tmp / f"{name}.{r}.npz"))
            with open(tmp / f"{name}.{r}.json") as f:
                ranks.append((arr, json.load(f)))
        out[name] = ranks
    out["collectives"] = [dict(np.load(tmp / f"collectives.{r}.npz"))
                          for r in range(world)]
    return out


def _dp_run(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"dp{world}")
    scenarios, want = _prepare(world, tmp)
    run_ranks(world, {"scenarios": scenarios}, tmp)
    got = _results(world, tmp, [s["name"] for s in scenarios])
    return world, got, want


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return _dp_run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    return _dp_run(4, tmp_path_factory)


def _cases():
    return [(name, w) for name, (worlds, _o, _n, extra) in SCENARIOS.items()
            for w in worlds if not extra.get("no_oracle")]


@pytest.mark.parametrize("name,world", _cases(),
                         ids=[f"{n}-dp{w}" for n, w in _cases()])
def test_dp_matches_jax_single_device_on_the_global_batch(request, name,
                                                          world):
    """N ranks at B/N rows against the JAX Trainer on one device at B:
    params (and BN running statistics) within the stated tolerances, the
    eval AUC within 5e-3 and the eval loss within 1e-4, the same step
    count; every rank holds the same params, bit for bit."""
    _, got, want = request.getfixturevalue(f"dp{world}")
    ranks = got[name]
    w = want[name]
    arr0, res0 = ranks[0]
    for arr, res in ranks[1:]:
        assert set(arr) == set(arr0)
        for k in arr:
            np.testing.assert_array_equal(arr[k], arr0[k], err_msg=k)
        for key in ("auc", "loss"):
            assert res["eval"][key] == res0["eval"][key], key
    assert res0["step"] == w["steps"]
    for key, val in w["params"].items():
        tol = FM_B_TOL if key == "fm_b" else PARAM_TOL
        np.testing.assert_allclose(arr0[f"p.{key}"], val, err_msg=key, **tol)
    for key, val in w["state"].items():
        np.testing.assert_allclose(arr0[f"s.{key}"], val, err_msg=key,
                                   **PARAM_TOL)
    loss_tol = BN_EVAL_LOSS_TOL if name == "bn" else EVAL_LOSS_TOL
    assert abs(res0["eval"]["loss"] - float(w["eval"]["loss"])) <= loss_tol
    assert abs(res0["eval"]["auc"] - float(w["eval"]["auc"])) <= AUC_TOL


@pytest.mark.parametrize("world", [2, 4])
def test_dp_collective_accounting(request, world):
    """``fit`` reports one all_reduce per optimizer apply (accumulation:
    once per apply, not per microbatch), its payload, and the strategy:
    hierarchical where ``_hier_groups`` is set, else flat."""
    _, got, want = request.getfixturevalue(f"dp{world}")
    tr = Trainer(Config(**_kw()), device="cpu")
    payload = tr._grad_payload_bytes()
    for name in got:
        if name in ("collectives", "dropout"):
            continue
        fit = got[name][0][1]["fit"]
        applies = want[name]["steps"]
        if name == "skip":  # the skipped dispatch's all_reduces ran
            applies = SCENARIOS[name][2]
        if name == "accum":
            applies = want[name]["steps"] // 2
        assert fit["collective_applies"] == applies, name
        strategy = "hierarchical" if name == "hier" else "flat"
        assert fit["collective_strategy"] == strategy, name
        if name == "dense":
            assert fit["collective_bytes"] == applies * payload


def test_sparse_under_a_mesh_trains_dense(dp2):
    """``--embedding_update sparse`` under a mesh trains with the dense
    update (checked against the JAX dense trajectory above)."""
    _, got, _ = dp2
    assert all(res["sparse_embed"] is False for _, res in got["sparse"])


def test_dropout_ranks_stay_replicated(dp2):
    """With dropout on every rank draws its own masks, yet the averaged
    update leaves every rank the same params, bit for bit."""
    _, got, want = dp2
    (a0, r0), (a1, r1) = got["dropout"]
    assert r0["step"] == r1["step"] == want["dropout"]["steps"]
    for k in a0:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
        assert np.all(np.isfinite(a0[k])), k


def test_dropout_generator_folds_rank_step_and_microbatch():
    """Under a mesh the dropout generator is seeded from (seed, step,
    microbatch, rank): ranks draw differently, a repeat of the same
    (step, microbatch) draws the same; one device keeps the state's."""
    cfg = Config(**_kw(dropout="0.5,0.5"))
    trs = []
    for rank in (0, 1):
        tr = Trainer(cfg, device="cpu",
                     mesh_info=mesh_lib.MeshInfo(data_size=2))
        tr._rank = rank
        trs.append(tr)
    state = trs[0].init_state()

    def draw(tr, step, micro=0):
        state.step = step
        return torch.rand(16, generator=tr._dropout_generator(state, micro))

    assert not torch.equal(draw(trs[0], 3), draw(trs[1], 3))
    assert torch.equal(draw(trs[0], 3), draw(trs[0], 3))
    assert not torch.equal(draw(trs[0], 3), draw(trs[0], 4))
    assert not torch.equal(draw(trs[0], 3, 0), draw(trs[0], 3, 1))
    one = Trainer(cfg, device="cpu")
    assert one._dropout_generator(state) is state.rng


@pytest.mark.parametrize("world", [2, 4])
def test_auc_psum_is_exact(request, world):
    """Every rank's histograms summed over the ranks equal the histograms
    of all ranks' predictions binned at once, exactly."""
    _, got, _ = request.getfixturevalue(f"dp{world}")
    probs, labels = [], []
    for r in range(world):
        rng = np.random.default_rng(100 + r)
        probs.append(rng.random(200).astype(np.float32))
        labels.append(rng.integers(0, 2, 200).astype(np.float32))
    whole = metrics_lib.auc_update(
        metrics_lib.auc_init(50), torch.from_numpy(np.concatenate(probs)),
        torch.from_numpy(np.concatenate(labels)))
    for r in range(world):
        np.testing.assert_array_equal(got["collectives"][r]["pos"],
                                      whole.pos.numpy())
        np.testing.assert_array_equal(got["collectives"][r]["neg"],
                                      whole.neg.numpy())


def test_hierarchical_psum_within_two_ulp_of_flat(dp4):
    """The 2x2 two-stage sum adds the flat all_reduce's terms in another
    association: within 2 ulp of it (the ulp of the terms' absolute sum,
    the scale of a reassociation's rounding), the same on every rank; the
    pmean is the sum times 1/4."""
    world, got, _ = dp4
    c = got["collectives"]
    flat = c[0]["flat"]
    ulp = np.spacing(c[0]["scale"].astype(np.float32))
    for r in range(world):
        np.testing.assert_array_equal(c[r]["hier"], c[0]["hier"])
        assert np.all(np.abs(c[r]["hier"] - flat) <= 2 * ulp)
        np.testing.assert_array_equal(c[r]["hier_mean"],
                                      c[r]["hier"] * np.float32(0.25))


def test_hier_run_matches_flat_run(dp4):
    """A 4-rank Trainer with the forced 2x2 hierarchy against the flat
    4-rank run from the same weights and batches (and both against the
    single device, above)."""
    _, got, _ = dp4
    hier, flat = got["hier"][0][0], got["dense"][0][0]
    for k in hier:
        np.testing.assert_allclose(hier[k], flat[k], err_msg=k, **PARAM_TOL)


# ---------------------------------------------------------------------------
# In-process: the mesh, the payload, the learning rate, the fallbacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(embedding_buckets=BUCKETS),
                                dict(batch_norm=True),
                                dict(model="dcnv2"), dict(model="widedeep"),
                                dict(model="din", history_max_len=L)],
                         ids=["deepfm", "hashed", "bn", "dcnv2", "widedeep",
                              "din"])
def test_grad_payload_bytes_matches_jax(kw):
    """``mesh.grad_payload_bytes`` over the port's params equals the JAX
    package's over its param tree (the dense leg, one model column; and
    the ``embedding_shard rows`` leg, the full table plus the touched
    mask, which the data-only row plane reduces)."""
    jax, JaxConfig, JaxTrainer, flatten, _ = _jax()
    from deepfm_tpu.parallel import mesh as jax_mesh  # noqa: PLC0415
    jt = JaxTrainer(JaxConfig(**_kw(**kw), mesh_data=1, mesh_model=1))
    js = jt.init_state()
    names = tuple(jt._embed_names)
    want = jax_mesh.grad_payload_bytes(js.params, names, 1)
    tr = Trainer(Config(**_kw(**kw)), device="cpu")
    assert tr._grad_payload_bytes() == want
    keys = [k for n in names for k in tr._embed_keys[n].values()]
    params = dict(tr.model.named_parameters())
    assert mesh_lib.grad_payload_bytes(
        params, keys, 1, embedding_shard="rows") == \
        jax_mesh.grad_payload_bytes(js.params, names, 1,
                                    embedding_shard="rows")


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("opt", ["adam", "adagrad", "momentum", "ftrl"])
def test_lr_scaling_matches_jax(opt, scale, world):
    """``build_optimizer(cfg, world_size=N)``: one update of the same
    params and grads equals the JAX package's optax update, the learning
    rate scaled by N exactly when ``scale_lr_by_world``."""
    jax, JaxConfig, _, _, _ = _jax()
    import jax.numpy as jnp  # noqa: PLC0415
    from deepfm_tpu.train import optimizers as jax_opt  # noqa: PLC0415
    kw = dict(optimizer=opt, learning_rate=0.01, scale_lr_by_world=scale)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((5, 3)).astype(np.float32)
    g = rng.standard_normal((5, 3)).astype(np.float32)
    tx = jax_opt.build_optimizer(JaxConfig(**kw), world_size=world)
    jp = {"w": jnp.asarray(p)}
    upd, _ = tx.update({"w": jnp.asarray(g)}, tx.init(jp), jp)
    want = p + np.asarray(upd["w"])
    port = opt_lib.build_optimizer(Config(**kw), world_size=world)
    tp = {"w": torch.from_numpy(p.copy())}
    port.apply(tp, {"w": torch.from_numpy(g)}, port.init(tp))
    np.testing.assert_allclose(tp["w"].numpy(), want, rtol=1e-6, atol=1e-7)
    assert port.lr == pytest.approx(0.01 * (world if scale else 1))


def test_sparse_under_mesh_warns_and_falls_back_like_jax(caplog):
    """The sparse update under a mesh warns and trains dense, as the JAX
    Trainer's ``sparse_embed`` turns False under its mesh."""
    _, JaxConfig, JaxTrainer, _, _ = _jax()
    kw = _kw(embedding_update="sparse")
    jt = JaxTrainer(JaxConfig(**kw, mesh_data=2, mesh_model=1))
    with caplog.at_level("WARNING"):
        tr = Trainer(Config(**kw), device="cpu",
                     mesh_info=mesh_lib.MeshInfo(data_size=2))
    assert tr.sparse_embed is False and jt.sparse_embed is False
    assert "falling back to dense" in caplog.text
    assert "embed" not in tr.init_state().opt_state


def test_tiering_under_mesh_raises_like_jax():
    _, JaxConfig, JaxTrainer, _, _ = _jax()
    kw = _kw(embedding_update="sparse", embedding_tiering="hot_cold",
             embedding_hot_rows=512, steps_per_loop=1)
    with pytest.raises(ValueError, match="hot_cold requires the sparse"):
        JaxTrainer(JaxConfig(**kw, mesh_data=2, mesh_model=1))
    with pytest.raises(ValueError, match="hot_cold requires the sparse"):
        Trainer(Config(**kw), device="cpu",
                mesh_info=mesh_lib.MeshInfo(data_size=2))


@pytest.mark.parametrize("mesh_data,world,ok", [(0, 1, True), (0, 4, True),
                                                (4, 4, True), (2, 4, False),
                                                (2, 1, False)])
def test_build_mesh_data_axis(mesh_data, world, ok):
    """``mesh_data`` 0 or the world size; anything else raises naming the
    flag. A 1x1 mesh is no mesh."""
    cfg = Config(**_kw(mesh_data=mesh_data))
    if not ok:
        with pytest.raises(ValueError, match="--mesh_data"):
            mesh_lib.build_mesh(cfg, world=world)
        return
    info = mesh_lib.build_mesh(cfg, world=world)
    assert info.data_size == world and info.model_size == 1
    assert info.is_mesh == (world > 1)


@pytest.mark.parametrize("hosts,want", [
    (["a", "a", "b", "b"], ([[0, 1], [2, 3]], [[0, 2], [1, 3]])),
    (["a", "a", "a", "a"], None), (["a", "b"], None),
    (["a", "b", "a", "b"], None), (["a", "a", "a", "b"], None),
    (["h0"] * 4 + ["h1"] * 4, ([[0, 1, 2, 3], [4, 5, 6, 7]],
                               [[0, 4], [1, 5], [2, 6], [3, 7]])),
])
def test_host_groups_match_jax_rule(hosts, want):
    """The (intra, inter) groups of a host layout: the JAX package's rule
    over data-axis rows, from host names."""
    got = mesh_lib.host_groups_from_hosts(hosts)
    assert (got if got is None else (got[0], got[1])) == want


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
