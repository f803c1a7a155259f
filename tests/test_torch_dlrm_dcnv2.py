"""DLRM-DCNv2 (``--model dlrm_dcnv2``) on the port, at a small size on the
CPU, against the plain float32 reference ``tests/dlrm_dcnv2_reference.py``:
the forward, loss and per-leaf gradients, three steps of the published
Adagrad through ``Trainer.train_step`` on the sparse update, the
per-feature plans (a 3-row table's long run; a table past
``PLAN_COUNT_MAX_ROWS`` on the counting plan's plain version; the sort
leg under ``--embedding_kernels off``), and the configuration's
refusals."""

import os
import sys

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.models import get_model
from deepfm_tpu_torch.ops import embedding_kernels as ek
from deepfm_tpu_torch.train import Trainer, optimizers

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import dlrm_dcnv2_reference as ref  # noqa: E402

torch.set_num_threads(1)

ROWS = [3, 10, 50, 1000]
HOT = [1, 3, 7, 2]
K, B = 8, 32
F = ref.DENSE + sum(HOT)

# float32 on both sides, the same products in another association and sum
# order (the port's bags through the take and a stack, its head a row-wise
# dot). Measured here: logits 3.0e-8, loss 0, gradients 1.2e-7 of the
# leaf's largest entry; with bfloat16 products 8.3e-3, 9.2e-6 and 0.13.
# So 1e-6 on the logits and 2e-6 of the leaf's scale on the gradients
# leave 16-33x room, and bfloat16 fails both by three orders.
LOGIT_ATOL, GRAD_RTOL = 1e-6, 2e-6
# Three Adagrad steps at lr 0.1: each step moves an entry by about lr times
# g / sqrt(acc), so the gradients' float32 gaps reach the parameters
# scaled down. Measured: 1.5e-7 (losses 1.2e-7); with bfloat16 products
# 0.24 (losses 5.8e-3), checked below; 2e-6 separates the two.
PARAM_ATOL = 2e-6
LR = 0.1


def _cfg(**kw):
    base = dict(model="dlrm_dcnv2", field_size=F, embedding_size=K,
                bottom_layers="16,8", feature_hotness=",".join(map(str, HOT)),
                table_rows=",".join(map(str, ROWS)), deep_layers="16,8",
                dropout="1.0,1.0", cross_layers=2, cross_rank=4,
                embedding_update="sparse", optimizer="exact_adagrad",
                l2_reg=0.0, compute_dtype="float32", batch_size=B,
                learning_rate=LR, scale_lr_by_world=False, mesh_data=1,
                log_steps=0, seed=7)
    base.update(kw)
    return Config(**base)


def _batch(seed, b=B, rows=ROWS, hot=HOT):
    g = torch.Generator().manual_seed(seed)
    ids = [torch.arange(ref.DENSE, dtype=torch.int32).expand(b, ref.DENSE)]
    ids += [torch.randint(0, r, (b, h), generator=g, dtype=torch.int32)
            for r, h in zip(rows, hot)]
    vals = torch.cat([torch.log1p(torch.rand((b, ref.DENSE), generator=g)
                                  * 20), torch.ones((b, sum(hot)))], dim=1)
    label = (torch.rand((b, 1), generator=g) < 0.3).float()
    return {"feat_ids": torch.cat(ids, dim=1), "feat_vals": vals,
            "label": label}


def _params(named):
    """Seeded random weights: the model's, with random biases so that every
    leaf carries a gradient of its own."""
    g = torch.Generator().manual_seed(3)
    out = {}
    for k, v in named.items():
        x = v.detach().clone()
        if k.endswith(".b"):
            x = 0.1 * torch.randn(x.shape, generator=g)
        out[k] = x
    return out


def test_forward_loss_and_gradients_match_the_reference():
    model = get_model(_cfg(), device="cpu")
    params = _params(dict(model.named_parameters()))
    model.load_state_dict(params)
    batch = _batch(1)
    ref_loss, ref_grads = ref.loss_and_grads(params, batch, HOT)
    model.train()
    z = model(batch["feat_ids"], batch["feat_vals"])
    want = ref.logits(params, batch["feat_ids"], batch["feat_vals"], HOT)
    torch.testing.assert_close(z, want, atol=LOGIT_ATOL, rtol=0)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        z, batch["label"].reshape(-1))
    torch.testing.assert_close(loss, ref_loss, atol=LOGIT_ATOL, rtol=0)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    assert set(names) == set(ref_grads)
    for k, g in zip(names, grads):
        scale = float(ref_grads[k].abs().max())
        assert scale > 0, k
        torch.testing.assert_close(g, ref_grads[k], rtol=0,
                                   atol=GRAD_RTOL * scale, msg=k)


def _trained(compute_dtype):
    cfg = _cfg(compute_dtype=compute_dtype)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    params = _params(state.params)
    trainer.load_weights(state, params, dict(state.model_state))
    batches = [_batch(10 + i) for i in range(3)]
    losses = []
    for batch in batches:
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses, ref.train_steps(params, batches, HOT, lr=LR)


def test_three_sparse_adagrad_steps_match_the_reference():
    state, losses, want = _trained("float32")
    np.testing.assert_allclose(losses, want["losses"], atol=LOGIT_ATOL,
                               rtol=0)
    assert set(state.params) == set(want["params"])
    for k, v in state.params.items():
        torch.testing.assert_close(v.detach(), want["params"][k], rtol=0,
                                   atol=PARAM_ATOL, msg=k)
    # An untouched row moves neither itself nor its accumulator.
    acc = state.opt_state["embed"]["embedding"]["t3"]
    seen = torch.zeros(ROWS[3], dtype=torch.bool)
    for i in range(3):
        seen[_batch(10 + i)["feat_ids"][:, F - HOT[3]:].long()] = True
    assert not seen.all()
    assert torch.count_nonzero(acc[~seen]) == 0


def test_bfloat16_products_fail_the_parameter_tolerance():
    state, _, want = _trained("bfloat16")
    worst = max(float((v.detach() - want["params"][k]).abs().max())
                for k, v in state.params.items())
    assert worst > 10 * PARAM_ATOL


def test_first_accumulator_is_the_first_gradient_squared():
    """Adagrad's accumulator starts at 0, so after one step its square
    root's norm is the first gradient's: what the benchmark reads."""
    cfg = _cfg()
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    params = _params(state.params)
    trainer.load_weights(state, params, dict(state.model_state))
    batch = _batch(5)
    _, grads = ref.loss_and_grads(params, batch, HOT)
    trainer.train_step(state, batch)
    opt = state.opt_state
    accs = {**opt["base"]["sum_of_squares"],
            **{f"embedding.{k}": v
               for k, v in opt["embed"]["embedding"].items()}}
    assert set(accs) == set(grads)
    for k, acc in accs.items():
        np.testing.assert_allclose(
            float(torch.sqrt(acc.double().sum())),
            float(torch.linalg.vector_norm(grads[k].double())), rtol=1e-5)


def test_dense_exact_adagrad_matches_the_formula():
    p = {"w": torch.randn(6, 3)}
    opt = optimizers.ExactAdagrad(0.5)
    state = opt.init(p)
    q = {"w": p["w"].clone()}
    acc = torch.zeros(6, 3)
    for i in range(3):
        g = {"w": torch.randn(6, 3) * (i + 1)}
        g["w"][0] = 0.0
        opt.apply(q, g, state)
        acc = acc + g["w"] * g["w"]
        p["w"] = p["w"] + (g["w"] / (torch.sqrt(acc) + 1e-8)) * -0.5
    torch.testing.assert_close(q["w"], p["w"], rtol=0, atol=1e-6)
    torch.testing.assert_close(state["sum_of_squares"]["w"], acc)


def _segments_oracle(inv, slots):
    order = np.argsort(inv.reshape(-1), kind="stable")
    starts = np.searchsorted(np.sort(inv.reshape(-1)), np.arange(slots + 1))
    return order, starts


@pytest.mark.parametrize("count_max,kernels", [
    (ek.PLAN_COUNT_MAX_ROWS, "auto"), (100, "auto"), (100, "off")])
def test_feature_plan_per_table(monkeypatch, count_max, kernels):
    """Each feature's plan is ``reference_plan_numpy`` of its own column
    span. At B = 1,024 the 3-row table of hotness 1 holds runs above
    ``LONG_RUN`` positions (the take backward's long-run path). With the
    counting kernel's bound patched to 100 rows the 1,000-row table takes
    the counting plan's plain version (touched marks, no host sync) and
    the others the kernel leg; under ``--embedding_kernels off`` every
    table takes the sort leg (no touched marks). The segments, built in
    one call for each hotness, are the stable order of each inv."""
    monkeypatch.setattr(ek, "PLAN_COUNT_MAX_ROWS", count_max)
    b = 1024
    emb = get_model(_cfg(embedding_kernels=kernels), device="cpu").emb
    ids = _batch(2, b=b)["feat_ids"]
    plan = emb._feature_plan(ids, True)
    assert list(plan) == ["t0", "t1", "t2", "t3"]
    for f, (key, e) in enumerate(plan.items()):
        cols = ids[:, emb.starts[f]:emb.starts[f + 1]]
        uids, inv, touched, _ = ek.reference_plan_numpy(cols.numpy(),
                                                        ROWS[f])
        np.testing.assert_array_equal(e.uids.numpy(), uids)
        np.testing.assert_array_equal(e.inv.numpy(), inv)
        assert (e.touched is None) == (kernels == "off")
        if e.touched is not None:
            np.testing.assert_array_equal(e.touched.numpy(), touched)
        order, starts = _segments_oracle(inv, e.uids.shape[0])
        np.testing.assert_array_equal(e.segments[0].numpy(), order)
        np.testing.assert_array_equal(e.segments[1].numpy(), starts)
    runs = np.diff(plan["t0"].segments[1].numpy())
    assert runs[:3].min() > ek.LONG_RUN and runs[:3].sum() == b


def test_pooled_views_match_on_both_paths():
    """The sparse path's pooled bags (views over gathered rows) equal the
    dense path's (lookups in the tables)."""
    model = get_model(_cfg(), device="cpu")
    ids = _batch(4)["feat_ids"]
    entry = model.emb.entry(dict(model.named_parameters()), "embedding")
    plan = model.emb.sparse_plan(ids)
    rows = model.emb.gather_rows(entry, plan)
    torch.testing.assert_close(model.emb.pool_rows(rows, plan),
                               model.emb.pool(entry, ids), rtol=0, atol=0)


REFUSALS = {
    "hotness_rows_lengths": (dict(feature_hotness="1,3,7",
                                  field_size=ref.DENSE + 11),
                             "one table per feature"),
    "field_size": (dict(field_size=F + 1), "field_size must be"),
    "hashed": (dict(embedding_buckets="64,32"), "unset embedding_buckets"),
    "hot_cold": (dict(embedding_tiering="hot_cold", embedding_hot_rows=8),
                 "embedding_tiering off"),
    "dense_update": (dict(embedding_update="dense"),
                     "embedding_update sparse"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_config_refuses(case):
    kw, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        _cfg(**kw)


@pytest.mark.parametrize("kw", [dict(embedding_tiering="hot_cold",
                                     embedding_hot_rows=8),
                                dict(grad_accum_steps=2)])
def test_sparse_exact_adagrad_refused_off_the_plain_step(kw):
    with pytest.raises(ValueError, match="one card's sparse step only"):
        Config(embedding_update="sparse", optimizer="exact_adagrad",
               feature_size=100, **kw)


def test_sparse_update_names_both_optimizers():
    with pytest.raises(ValueError, match="Adam .*exact_adagrad"):
        Config(embedding_update="sparse", optimizer="Adagrad")
    assert Config(embedding_update="sparse", optimizer="exact_adagrad")


def test_per_feature_fields_belong_to_the_model():
    with pytest.raises(ValueError, match="belong to --model dlrm_dcnv2"):
        Config(table_rows="3,4")
