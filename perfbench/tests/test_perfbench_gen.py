"""The frozen traffic generator: the same seed gives the same columns and
weights, another seed others; the integer fields are one id each, the
categorical ids stay in their field's slice; the labels follow the
hidden model."""

import numpy as np
import pytest
import torch

from perfbench.gen import traffic as gen

MIX = {"integer_fields": 3}
SEEDS = [0, 7, 2**31 + 11, 2**40 + 3, -5]


def cols(seed, records=4096, vocab=3000, fields=10):
    return gen.make_columns(MIX, vocab=vocab, fields=fields, records=records,
                            seed=seed, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_columns(seed):
    a, b = cols(seed), cols(seed)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_other_seed_other_columns():
    a, b = cols(1), cols(2)
    assert not torch.equal(a["ids"], b["ids"])
    assert not torch.equal(a["vals"], b["vals"])


def test_blocks_do_not_change_the_draw(monkeypatch):
    """Rows past one block (``CHUNK``) are drawn on from the same stream:
    a smaller block size gives other rows, but the same seed repeats."""
    monkeypatch.setattr(gen, "CHUNK", 1000)
    a, b = cols(4), cols(4)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert len(torch.unique(a["ids"][:, 5])) > 100


def test_layout():
    c = cols(3)
    s = gen.slice_size(3000, 10, 3)
    assert s == (3000 - 3) // 7
    ids, vals = c["ids"], c["vals"]
    assert ids.dtype == torch.int32
    # Integer fields: field f is id f, at every row, its value N(0, 1).
    assert torch.equal(ids[:, :3], torch.arange(3, dtype=torch.int32)
                       .expand(4096, 3))
    assert abs(float(vals[:, :3].std()) - 1.0) < 0.05
    # Categorical fields: their own slice, value 1, every id of it drawn.
    f = torch.arange(7)[None, :]
    lo = 3 + f * s
    assert bool(((ids[:, 3:] >= lo) & (ids[:, 3:] < lo + s)).all())
    assert bool((vals[:, 3:] == 1.0).all())
    assert len(torch.unique(ids[:, 3])) == s
    assert set(torch.unique(c["label"]).tolist()) <= {0.0, 1.0}


def test_labels_follow_the_hidden_model():
    """The copied label model: a learnable signal, clicks near half."""
    c = cols(9, records=50_000)
    hidden = torch.randn((3000,), generator=torch.Generator().manual_seed(
        gen.HIDDEN_SEED))
    logit = 0.5 * torch.sum(hidden[c["ids"].long()] * c["vals"], dim=1)
    y = c["label"]
    assert float(y[logit > 2].mean()) > 0.8
    assert float(y[logit < -2].mean()) < 0.2
    assert 0.3 < float(y.mean()) < 0.7


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_by_seed(seed):
    shapes = {"fm_b": (1,), "fm_w": (3008,), "fm_v": (3008, 8),
              "tower.layers.0.w": (80, 16), "tower.layers.0.b": (16,)}
    real = {"fm_w": 3000, "fm_v": 3000}
    a = gen.make_weights(shapes, seed=seed, device="cpu", real_rows=real)
    b = gen.make_weights(shapes, seed=seed, device="cpu", real_rows=real)
    for k in shapes:
        assert torch.equal(a[k], b[k]) and tuple(a[k].shape) == shapes[k]
    assert float(a["fm_v"][3000:].abs().sum()) == 0.0
    assert float(a["fm_w"][3000:].abs().sum()) == 0.0
    assert float(a["tower.layers.0.b"].abs().sum()) == 0.0
    lim = np.sqrt(6.0 / 96)
    assert float(a["tower.layers.0.w"].abs().max()) <= lim
    c = gen.make_weights(shapes, seed=seed + 1, device="cpu", real_rows=real)
    assert not torch.equal(a["fm_v"], c["fm_v"])
