"""The DLRM-DCNv2 family (``perfbench/families/dlrm_dcnv2.py``) at a tiny
size on the CPU: its reference over the touched rows reads what the plain
reference reads over whole tables, its leaves are made again alike, and a
run of the cell through ``process.run_process`` is correct at ``--trace``
0 and 1 and not under the half-batch fault."""

import time

import pytest
import torch

from perfbench.core import compare, process, registry
from perfbench.reference import dlrm_dcnv2 as ref
from perfbench.tests import tiny

FAMILY = registry.family("dlrm_dcnv2")
CELL = "dlrm_dcnv2.train.multihot"
SEED = 2**33 + 5


def _cell():
    cell = registry.Registry().cell(CELL)
    flags = cell["config"]["flags"]
    rows = [min(int(r), 500) for r in flags["table_rows"].split(",")]
    flags.update(table_rows=",".join(map(str, rows)), feature_size=sum(rows),
                 embedding_size=8, bottom_layers="16,8", deep_layers="16,8",
                 dropout="1.0,1.0", cross_rank=4, compute_dtype="float32")
    cell["traffic"].update(batch_per_card=64, records_per_card=2048,
                           trace_steps=8, steps_per_call=4)
    cell["limits"] = dict(tiny.LIMITS)
    return cell


def _shapes(cell):
    """The program's leaf shapes for the tiny cell."""
    from deepfm_tpu_torch.train.loop import Trainer
    from perfbench.core import train_cell
    cfg = train_cell.program_config(cell, SEED)
    return {k: tuple(v.shape) for k, v in
            Trainer(cfg, device="cpu").model.named_parameters()}


def test_reference_over_touched_rows_is_the_whole_tables():
    cell = _cell()
    flags, t = cell["config"]["flags"], cell["traffic"]
    cols = FAMILY.columns(cell, SEED, torch.device("cpu"))
    held = FAMILY.hold(FAMILY.weights(cell, _shapes(cell), SEED, "cpu"),
                       cell, SEED)
    b = int(t["batch_per_card"])
    batches = [{k: x[i * b:(i + 1) * b] for k, x in cols.items()}
               for i in range(3)]
    hot = [int(x) for x in flags["feature_hotness"].split(",")]
    whole = ref.train_steps({k: held[k] for k in held},
                            [dict(x, ids=x["ids"].long()) for x in batches],
                            hot, lr=float(flags["learning_rate"]))
    got = FAMILY.reference(cell, held, batches, torch.device("cpu"))
    assert got["losses"] == pytest.approx(whole["losses"], rel=1e-6)
    for key in ("grad1", "change"):
        want = compare.norms(whole[key])
        assert set(got[key]) == set(want)
        for leaf, v in want.items():
            assert got[key][leaf] == pytest.approx(v, rel=1e-5, abs=1e-12)


def test_leaves_are_made_again_alike():
    cell = _cell()
    shapes = _shapes(cell)
    a = FAMILY.weights(cell, shapes, SEED, "cpu")
    b = FAMILY.weights(cell, shapes, SEED, "cpu")
    assert set(a) == set(shapes)
    for k in shapes:
        assert torch.equal(a[k], b[k]) and tuple(a[k].shape) == shapes[k]
    other = FAMILY.weights(cell, shapes, SEED + 1, "cpu")
    assert not torch.equal(a["embedding.t0"], other["embedding.t0"])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_on_the_cpu(trace):
    res, _ = process.run_process(_cell(), seed=SEED, seconds=0.5,
                                 trace=trace, device="cpu", t0=time.time())
    assert res["correct"], res["checks"]
    if trace:
        assert "dlrm_mfu_pct" in res["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_fault_is_not_correct(monkeypatch, fault):
    from deepfm_tpu_torch.train import loop
    # Restored when the test ends: the plant patches the class.
    monkeypatch.setattr(loop.Trainer, "train_step", loop.Trainer.train_step)
    tiny.plant(fault)
    res, _ = process.run_process(_cell(), seed=SEED, seconds=0.5, trace=0,
                                 device="cpu", t0=time.time())
    assert not res["correct"]


def _small_shapes():
    """Step shapes at two features of hotness 1 and 3, K = 4, B = 10."""
    flags = {"feature_hotness": "1,3", "table_rows": "7,50",
             "embedding_size": 4, "bottom_layers": "6,4",
             "deep_layers": "5", "cross_rank": 2, "cross_layers": 1,
             "compute_dtype": "bfloat16"}
    return FAMILY.step_shapes(flags, 10, {})


def test_take_bwd_and_segments_counts_by_hand():
    s = _small_shapes()
    # Feature 0: N = U = 10; feature 1: N = U = 30; D = 4, float32.
    assert registry.kernel("dlrm_take_bwd").need(s) == [
        (40, 4 * 40 + 4 * 10 + 4 * 11 + 4 * 40, "f32_flops_per_s"),
        (120, 4 * 120 + 4 * 30 + 4 * 31 + 4 * 120, "f32_flops_per_s")]
    assert registry.kernel("dlrm_segments").need(s) == [
        (0, 4 * 10 + 4 * 10 + 4 * 11, "f32_flops_per_s"),
        (0, 4 * 30 + 4 * 30 + 4 * 31, "f32_flops_per_s")]


@pytest.mark.parametrize("name,base", [
    ("dlrm_launches_per_step", "train_launches_per_step"),
    ("dlrm_feed_span_ms", "feed_span_ms"),
    ("dlrm_backward_self_span_ms", "backward_self_span_ms")])
def test_reused_readers_read_as_their_originals(name, base):
    """Each reads what the reader it reuses reads, on a synthetic window
    (and None on an empty one)."""
    from perfbench.core import device_trace
    from perfbench.tests import test_perfbench_spans as spans

    ops = [device_trace.DeviceOp("k", "kernel", 10 * i, 5)
           for i in range(12)]
    ctx = spans.window(spans.two_dispatches(), 4)
    ctx.ops = ops
    got = registry.metric(name).read(ctx)
    assert got is not None and got == registry.metric(base).read(ctx)
    assert registry.metric(name).read(spans.window([], 4)) is None
