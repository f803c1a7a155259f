"""The sparse exact-Adagrad update of the per-feature tables
(``train/optimizers.py``: ``sparse_adagrad_tables``, its plain version
``sparse_adagrad_apply_tables`` and the kernel ``dfm_sparse_adagrad`` of
``csrc/optimizer.cu``).

On the CPU: the ``"adagrad"`` seam's legs for every ``--embedding_kernels``
mode and device; the kernel's input checks; the wrapper's CPU leg, for
every mode, bit-equal to the plain version at the plan's spread index
(the caller's index before the kernel) and to a numpy float32 oracle of
the formula, on plans whose fill slots collide with real rows (a 3-row
table with 16,384 slots) and with real rows whose gradient is exactly
zero.

On the card (marked ``card``, skipped without one): the kernel bit-equal
to the plain leg on the same cases over three consecutive steps, on its
16-byte and its scalar path, its launches counted and reaching the
``train.optimizer`` span's ``adagrad_launches``. Run from the
repository's root with
``python -m pytest --noconftest tests/test_torch_sparse_adagrad.py``.
"""

import json

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.obs import trace as trace_lib
from deepfm_tpu_torch.ops import embedding as emb_ops
from deepfm_tpu_torch.ops import embedding_kernels as ek
from deepfm_tpu_torch.train import optimizers as opt

LR, EPS = 0.004, 1e-8
# (rows, ids a step) per table: the 3-row table of the DLRM cell's feature
# 5 at 16,384 ids (16,381 fill slots over 3 real rows), tables where a few
# ids miss, and one where every row is touched.
TABLES = [(3, 16_384), (1000, 700), (64, 64), (5, 40)]


def _case(seed, k, tables=TABLES, dev="cpu", offset=0):
    """Plans, gradients, accumulators and tables of one step: fill slots'
    gradients zero (as the take backward leaves them), every third real
    slot's too; accumulators from 0 on a few rows. ``offset``: elements
    by which each float tensor starts past its allocation."""
    rng = np.random.default_rng(seed)

    def put(x):
        flat = torch.empty(offset + x.size, dtype=torch.float32, device=dev)
        out = flat[offset:].view(x.shape)
        out.copy_(torch.from_numpy(x))
        return out

    shape = () if k is None else (k,)
    uids, g, accs, tabs = [], [], [], []
    for rows, n in tables:
        ids = torch.from_numpy(rng.integers(0, rows, n, dtype=np.int32))
        u = emb_ops.make_plan_counting(ids, rows).uids
        gr = rng.standard_normal((n,) + shape).astype(np.float32)
        real = u.numpy() < rows
        gr[~real] = 0
        gr[np.flatnonzero(real)[::3]] = 0
        acc = rng.uniform(0, 2, (rows,) + shape).astype(np.float32)
        acc[::4] = 0
        uids.append(u.to(dev))
        g.append(put(gr))
        accs.append(put(acc))
        tabs.append(put(rng.uniform(-1, 1, (rows,) + shape).astype(
            np.float32)))
    return g, uids, accs, tabs


def _spread_index(u, rows):
    """The plan's spread index as the step built it before the kernel
    (``EmbeddingSchema.spread_index``)."""
    entry = emb_ops.PlanEntry(uids=u, inv=None, mask=None, num_rows=rows)
    spread = torch.remainder(torch.arange(u.shape[0], dtype=torch.int32,
                                          device=u.device), rows)
    return emb_ops.spread_index(entry, spread)


def _oracle(g, uids, accs, tabs):
    """numpy float32, one rounding an operation, at the real slots."""
    out = []
    lr, eps = np.float32(LR), np.float32(EPS)
    for gr, u, acc, tab in zip(g, uids, accs, tabs):
        gr, u = gr.cpu().numpy(), u.cpu().numpy()
        acc, tab = acc.cpu().numpy().copy(), tab.cpu().numpy().copy()
        real = u < tab.shape[0]
        r, x = u[real], gr[real]
        a = acc[r] + x * x
        den = np.sqrt(a) + eps
        acc[r] = a
        tab[r] = tab[r] + (x / den) * -lr
        out.append((acc, tab))
    return out


def _clone(xs):
    return [x.clone() for x in xs]


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("dev", ["cpu", "cuda"])
@pytest.mark.parametrize("mode", ek.MODES)
def test_adagrad_seam_legs(mode, dev):
    want = "kernel" if mode in ("auto", "pallas") and dev == "cuda" \
        else "plain"
    assert opt.adagrad_leg(mode, torch.device(dev)) == want
    assert ek.resolve(mode, "adagrad") == {
        "auto": "kernel", "pallas": "kernel", "xla": "opt",
        "off": "ref"}[mode]


@pytest.mark.parametrize("mode", ek.MODES)
def test_cpu_leg_matches_the_foreach_path_and_the_formula(mode):
    g, uids, accs, tabs = _case(1, 8)
    accs0, tabs0 = _clone(accs), _clone(tabs)
    old_a, old_t = _clone(accs), _clone(tabs)
    opt.sparse_adagrad_apply_tables(
        g, [_spread_index(u, t.shape[0]) for u, t in zip(uids, tabs)],
        old_a, lr=LR, eps=EPS, tables=old_t)
    before = opt.adagrad_launches
    opt.sparse_adagrad_tables(g, uids, accs, lr=LR, eps=EPS, tables=tabs,
                              mode=mode)
    assert opt.adagrad_launches == before
    for i, (acc, tab) in enumerate(_oracle(g, uids, accs0, tabs0)):
        assert torch.equal(_bits(accs[i]), _bits(old_a[i])), i
        assert torch.equal(_bits(tabs[i]), _bits(old_t[i])), i
        assert torch.equal(_bits(accs[i]), _bits(torch.from_numpy(acc))), i
        assert torch.equal(_bits(tabs[i]), _bits(torch.from_numpy(tab))), i
        # Rows no real slot names keep their bits.
        rows = tabs[i].shape[0]
        seen = torch.zeros(rows, dtype=torch.bool)
        seen[uids[i][uids[i] < rows].long()] = True
        assert torch.equal(_bits(tabs[i][~seen]), _bits(tabs0[i][~seen]))
        assert torch.equal(_bits(accs[i][~seen]), _bits(accs0[i][~seen]))
    # The 3-row table: every row real, 16,381 fill slots on them.
    assert int((uids[0] < 3).sum()) == 3 and uids[0].shape[0] == 16_384


def test_cpu_leg_one_dimensional_tables():
    g, uids, accs, tabs = _case(2, None)
    accs0, tabs0 = _clone(accs), _clone(tabs)
    opt.sparse_adagrad_tables(g, uids, accs, lr=LR, eps=EPS, tables=tabs)
    for i, (acc, tab) in enumerate(_oracle(g, uids, accs0, tabs0)):
        assert torch.equal(_bits(accs[i]), _bits(torch.from_numpy(acc))), i
        assert torch.equal(_bits(tabs[i]), _bits(torch.from_numpy(tab))), i


def _refusal(case):
    g, uids, accs, tabs = _case(3, 8, tables=[(10, 12), (20, 12)])
    if case == "bfloat16_table":
        tabs[1] = tabs[1].bfloat16()
    elif case == "float64_gradient":
        g[0] = g[0].double()
    elif case == "int64_uids":
        uids[0] = uids[0].long()
    elif case == "non_contiguous":
        accs[1] = accs[1].t().contiguous().t()
    elif case == "mixed_devices":
        g[1] = torch.empty(g[1].shape, device="meta")
    elif case == "no_tables":
        g, uids, accs, tabs = [], [], [], []
    elif case == "too_many_tables":
        n = opt.ADAGRAD_MAX_TABLES + 1
        g, uids, accs, tabs = g * n, uids * n, accs * n, tabs * n
    elif case == "two_widths":
        tabs[1], accs[1] = tabs[1][:, :4].contiguous(), accs[1][:, :4]
    elif case == "gradient_rows":
        g[0] = g[0][:-1]
    elif case == "one_accumulator_short":
        accs = accs[:1]
    return g, uids, accs, tabs


REFUSALS = {"bfloat16_table": (TypeError, "float32"),
            "float64_gradient": (TypeError, "float32"),
            "int64_uids": (TypeError, "int32 uids"),
            "non_contiguous": (ValueError, "contiguous"),
            "mixed_devices": (ValueError, "different devices"),
            "no_tables": (ValueError, "1 to 32 tables"),
            "too_many_tables": (ValueError, "1 to 32 tables"),
            "two_widths": (ValueError, "of one K"),
            "gradient_rows": (ValueError, r"gradients \[N\(,K\)\]"),
            "one_accumulator_short": (ValueError, "1 accumulators")}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_kernel_checks_refuse(case):
    err, match = REFUSALS[case]
    with pytest.raises(err, match=match):
        opt._check_sparse_adagrad(*_refusal(case))


@pytest.mark.parametrize("k", [1, 3, 8, 128])
def test_kernel_checks_take_any_width(k):
    """The kernel's 16-byte path takes K a multiple of 4; its scalar path
    every other K, so 1-D tables (DeepFM's fm_w) and odd K launch too."""
    shape = None if k == 1 else k
    opt._check_sparse_adagrad(*_case(4, shape, tables=[(10, 12)]))


@pytest.mark.parametrize("case", ["no_tables", "one_accumulator_short"])
def test_wrapper_refuses_on_every_leg(case):
    with pytest.raises(ValueError, match="accumulator a table"):
        g, uids, accs, tabs = _refusal(case)
        opt.sparse_adagrad_tables(g, uids, accs, lr=LR, eps=EPS,
                                  tables=tabs, mode="off")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# name: (K, element offset of every float tensor): the 16-byte path at the
# DLRM cell's K and a small one, the scalar path on an odd K, on 1-D
# tables and on rows that start 4 bytes past a 16-byte boundary.
CARD_CASES = {"k128": (128, 0), "k8": (8, 0), "k3_scalar": (3, 0),
              "one_dimensional": (None, 0), "k8_misaligned": (8, 1)}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_bit_equal_to_the_plain_leg(card, name):
    k, offset = CARD_CASES[name]
    _, _, accs, tabs = _case(5, k, dev=card, offset=offset)
    plain_a, plain_t = _clone(accs), _clone(tabs)
    before = opt.adagrad_launches
    for step in range(3):
        g, uids, _, _ = _case(10 + step, k, dev=card, offset=offset)
        opt.sparse_adagrad_tables(g, uids, accs, lr=LR, eps=EPS,
                                  tables=tabs)
        opt.sparse_adagrad_tables(g, uids, plain_a, lr=LR, eps=EPS,
                                  tables=plain_t, mode="xla")
        torch.cuda.synchronize()
        for i in range(len(tabs)):
            assert torch.equal(_bits(accs[i]), _bits(plain_a[i])), (step, i)
            assert torch.equal(_bits(tabs[i]), _bits(plain_t[i])), (step, i)
    assert opt.adagrad_launches == before + 3


@pytest.mark.card
def test_launches_reach_the_optimizer_span(card, tmp_path):
    g, uids, accs, tabs = _case(6, 8, dev=card)
    trace_lib.configure("full", export_env=False)
    try:
        with trace_lib.span("train.optimizer", device=card):
            for _ in range(2):
                opt.sparse_adagrad_tables(g, uids, accs, lr=LR, eps=EPS,
                                          tables=tabs)
        path = trace_lib.export(str(tmp_path / "trace.json"))
    finally:
        trace_lib.reset()
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("name") == "train.optimizer"]
    assert len(spans) == 1
    assert spans[0]["args"]["adagrad_launches"] == 2


@pytest.mark.card
def test_the_dlrm_step_launches_once_inside_its_optimizer_span(card,
                                                               tmp_path):
    from deepfm_tpu_torch.config import Config  # noqa: PLC0415
    from deepfm_tpu_torch.train import Trainer  # noqa: PLC0415
    rows, hot, b = [3, 50, 1000, 70_000], [1, 3, 7, 2], 512
    cfg = Config(model="dlrm_dcnv2", field_size=13 + sum(hot),
                 embedding_size=16, bottom_layers="32,16",
                 feature_hotness=",".join(map(str, hot)),
                 table_rows=",".join(map(str, rows)), deep_layers="32,16",
                 dropout="1.0,1.0", cross_layers=2, cross_rank=8,
                 embedding_update="sparse", optimizer="exact_adagrad",
                 l2_reg=0.0, batch_size=b, learning_rate=LR, log_steps=0)
    trainer = Trainer(cfg, device=card)
    state = trainer.init_state()
    rng = np.random.default_rng(8)
    ids = [np.zeros((b, 13), np.int32)] + [
        rng.integers(0, r, (b, h), dtype=np.int32) for r, h in zip(rows, hot)]
    batch = trainer.put_batch({
        "feat_ids": np.concatenate(ids, axis=1),
        "feat_vals": rng.random((b, 13 + sum(hot)), dtype=np.float32),
        "label": (rng.random((b, 1)) < 0.3).astype(np.float32)})
    state, _ = trainer.train_step(state, batch)  # builds the kernels
    before = opt.adagrad_launches
    trace_lib.configure("full", export_env=False)
    try:
        for _ in range(2):
            state, _ = trainer.train_step(state, batch)
        path = trace_lib.export(str(tmp_path / "trace.json"))
    finally:
        trace_lib.reset()
    assert opt.adagrad_launches == before + 2
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("name") == "train.optimizer"]
    assert len(spans) == 2
    for sp in spans:
        assert sp["args"]["adagrad_launches"] == 1
        assert sp["args"]["unique_rows"] > 0
