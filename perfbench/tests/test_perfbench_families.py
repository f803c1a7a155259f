"""The model families (``perfbench/families/``): DeepFM's family gives what
the frozen generator and reference give when called directly, bit for
bit, and a model with no family file is refused by name."""

import time

import pytest
import torch

from perfbench.core import compare, registry, train_cell
from perfbench.gen import traffic as gen
from perfbench.reference import models as ref
from perfbench.tests import tiny

SEEDS = [2**31 + 29, -3]
DEEPFM = registry.family("deepfm")


def _cell():
    return tiny.shrink(registry.Registry().cell(
        "deepfm_criteo.train.uniform"))


def _shapes(flags):
    v, k, f = (int(flags[n]) for n in ("feature_size", "embedding_size",
                                       "field_size"))
    rows = v + 8
    return {"fm_b": (1,), "fm_w": (rows,), "fm_v": (rows, k),
            "tower.layers.0.w": (f * k, 16), "tower.layers.0.b": (16,),
            "tower.layers.1.w": (16, 8), "tower.layers.1.b": (8,),
            "tower.out.w": (8, 1), "tower.out.b": (1,)}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("seed", SEEDS)
def test_deepfm_family_is_the_direct_calls(seed):
    cell = _cell()
    flags, t = cell["config"]["flags"], cell["traffic"]
    v = int(flags["feature_size"])
    cols = DEEPFM.columns(cell, seed, torch.device("cpu"))
    _equal(cols, gen.make_columns(
        t, vocab=v, fields=int(flags["field_size"]),
        records=int(t["records_per_card"]), seed=seed, device="cpu"))
    shapes = _shapes(flags)
    w0 = DEEPFM.weights(cell, shapes, seed, torch.device("cpu"))
    _equal(w0, gen.make_weights(shapes, seed=seed, device="cpu",
                                real_rows={"fm_w": v, "fm_v": v}))
    held = DEEPFM.hold(w0, cell, seed)
    _equal(held, w0)
    b = int(t["batch_per_card"])
    batches = [{k: x[i * b:(i + 1) * b] for k, x in cols.items()}
               for i in range(3)]
    params = {k: (x[:v] if k in ("fm_w", "fm_v") else x)
              for k, x in w0.items()}
    for kw in ({}, {"quant": True}, {"rows": slice(0, b // 2)}):
        got = DEEPFM.reference(cell, held, batches, torch.device("cpu"),
                               **kw)
        want = ref.train_steps(params, batches,
                               lr=float(flags["learning_rate"]),
                               l2=float(flags["l2_reg"]), **kw)
        assert got["losses"] == want["losses"]
        assert got["grad1"] == compare.norms(want["grad1"])
        assert got["change"] == compare.norms(want["change"])


def test_deepfm_first_gradient_is_adams_first_moment():
    mu = {"a": torch.randn(7), "b": torch.randn(3, 2)}
    got = DEEPFM.first_grad_norms({"mu": mu, "nu": {}, "count": 1})
    assert got == {k: float(torch.linalg.vector_norm(
        x.double() / (1.0 - 0.9))) for k, x in mu.items()}


def test_a_model_without_a_family_file_is_refused():
    with pytest.raises(ValueError, match=r"no reference for model 'nosuch'"
                       r".*perfbench/families/nosuch\.py"):
        registry.family("nosuch")
    cell = _cell()
    cell["config"]["flags"]["model"] = "no_such_model"
    with pytest.raises(ValueError, match=r"no reference for model "
                       r"'no_such_model'.*families/no_such_model\.py"):
        train_cell.Run(cell, seed=1, device="cpu", t0=time.time())
