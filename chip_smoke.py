#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deepfm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. The card's name and power limit (``nvidia-smi``); build every CUDA
   kernel of the port from ``deepfm_tpu_torch/csrc`` with nvcc, in parallel.
2. Kernel phase: the ``fused_fm`` forward kernel against ``reference_fm``
   (plain PyTorch) on the card, float32 and bfloat16 inputs, at the serving
   and training shapes and others that take its 16-byte vector path (K = 8,
   32, 64; F = 1) or its scalar path (K = 33, 48, and xv misaligned by one
   element); then the kernel's time at B = 1, 7, 256 and 1,024 beside its
   bound, the plain version's time and, in turns, the scalar path's (the
   previous design) at the same shape.
3. Backward kernel phase: the ``fused_fm`` backward kernel against
   ``reference_fm_bwd``, float32 and bfloat16, at the training shapes and a
   few others, with the gradients' dtypes, and ``torch.autograd.grad``
   through ``fused_fm`` against the same through ``reference_fm``; then its
   time beside its bound and the plain version's at the training shape.
4. Plan kernel phase: the plan build kernel (one cluster launch for up to
   8 tables) against its plain version ``make_plan_counting`` on the card
   and the numpy oracle, bit-equal uids, inv and touched (rank under
   touched), at one hashed table's training view (N = 1024*39 ids, 262,144
   rows, 3/4 of the positions at the fill id), the monolithic table, N = 1,
   all ids equal, all fill, N > rows, 2,000,000 rows, and N = 4096*39 (a
   batch of 4,096, more ids than one pass of a CTA holds) on a hashed
   and on the monolithic table, one table a launch; then four tables of
   262,144, 4,096, 1 and 2,000,000 rows in one launch, and the hashed
   step's four tables (the ids the timing uses). Then the times of one table's launch and of the hashed step's
   four-table launch beside their bounds, the plain version's and
   ``torch.unique``'s, and of a launch with almost no work (the design's
   fixed cost).
5. Take kernel phase: the fused gather forward, one table (bit-equal to
   ``rows[inv]``, and times its mask) and the hashed step's four masked
   tables summed (bit-equal to the plain composition), at D = 1 and 32;
   the segment-sum backward, one table a launch, bit-equal to the CPU
   position-order oracle and to its own second launch, and within a
   tolerance of the plain backward on the card, U = N = 39,936; the
   hashed step's four tables in one backward launch, bit-equal to the
   numpy ascending-p oracle, to its second launch and to one launch per
   table, and the gradients through ``TakeRowsSum`` (one launch each way)
   bit-equal to it; the four tables' position segments built per table
   by the plain versions (a sort each, one sort over a composite key) and
   by the segments kernel in one launch, bit-equal, with the device time
   and events of each.
   Then times beside the bounds, the plain versions and the library
   calls: ``index_select`` for one table, ``embedding_bag`` (sum, masks as
   per-sample weights, over the tables concatenated) for the four,
   ``index_add_`` for one table's backward and one ``index_add_`` over the
   four tables' outputs end to end for theirs.
   Before it, the segments kernel phase: ``dfm_segments`` (the counting
   sort that orders the take backward's positions, one launch for 1 to 8
   tables) bit-equal to its plain version on the card and to a numpy
   stable-argsort oracle on uniform, Zipf, all-one-slot, fill-slot,
   medium-run, N = 0 and 1, U >> N, U = 0 and 1, out-of-range and
   T = 1..8 inputs, with and without ``keep``; then its time and device
   events at the hashed step's, the dense lookups', the fused leg's and
   the dense hashed lookups' shapes beside its bound, the plain version's
   and ``torch.sort`` + ``searchsorted``'s.
6. Segment-sum phase: ``ek.segment_sum`` (one segments launch, then one
   take backward launch), which sums the dense lookups' and the monolithic
   fused leg's
   gradients in position order, at their shapes: bit-equal to the numpy
   ascending-p oracle and to its second call; its time beside the
   ``index_add_`` it replaces.
7. Install kernel phase: the hot/cold cache install (``dfm_install``) in
   place into the tier's two hot tables of 81,920 rows, fm_w (D = 1) and
   fm_v (D = 32), in one launch over one transaction of 10,000 installs
   padded to 16,384 slots (real slots drawn without replacement),
   bit-equal to ``reference_install`` per table on the card and to a
   numpy oracle, untouched rows and out-of-range slots left alone; then
   I = 1, every slot out of range and I = H; then times of the two-table
   launch (and of each table alone) beside the bound, the plain version's
   and the ``index_copy_`` calls' on the real slots.
8. Determinism: the dense, sparse monolithic and dense hashed layouts
   trained twice for 20 steps from the same seed on the same batches;
   losses and every embedding table must be bit-identical between the two
   runs (the embedding gradients sum in position order, not by float
   atomics).
9. Train parity: DeepFM at the reference width, one seeded init, 20 steps
   on the same batches (dropout keep 1.0) with the kernels
   (``use_pallas=True``) and with the plain path; the losses must agree.
   Then the same for the sparse update with hashed tables: kernels
   (``embedding_kernels=auto``) against the plain legs (``xla``, no fused
   FM). Then the hot/cold tier through ``fit`` (81,920 hot rows,
   ``transfer_ahead=2``): tiered against the untiered sparse monolithic
   run, and against the tier with the plain install leg (``xla``); losses
   and densified tables must agree.
10. Train phases: synthetic TFRecords at the reference width written once
   with the port's ``generate_synthetic_ctr``, then ``tasks.run`` train
   (the ``Config()`` defaults: dropout keep 0.5, Adam, batch 1024; two
   epochs, an eval after each), eval and export, all on the card, four
   times: the dense update, the sparse update on the monolithic table, the
   sparse update on 4 hashed tables of 262,144 rows, and the sparse update
   through the hot/cold tier (81,920 hot rows, float32 cold store,
   ``steps_per_loop=1``, ``transfer_ahead=2``); eval and infer go through
   the CLI entry point (``deepfm_tpu_torch.launch``). The logged loss must
   fall, eval AUC exceed 0.5, the FM backward kernel launch once per train
   step and the forward once per train step and eval batch, the plan
   kernel once and the take forward twice (fm_w, fm_v) per hashed step and
   never on the other layouts, the take backward twice per step on the
   dense and hashed layouts (once per name) and once per step on the
   monolithic and tiered ones (the fused leg, all names at once), the
   segments kernel once per step on every layout (the dense lookups of
   both names share one build), the
   install kernel once per tiered plan and never elsewhere; each trained
   artifact then serves. Then the step time at B=1024 of the dense kernel
   and plain paths, of the three untiered layouts (one step, with its
   device busy time and idle share; no sort kernel may run in their
   steps), and of the tier (per dispatch through ``fit``: plan, apply and
   step).
11. Serve phase: DeepFM at the reference width (``Config()`` defaults:
   V=117,581, F=39, K=32, tower 128-64-32, bfloat16 tower) with random
   weights from a seed, exported, published behind ``LATEST`` and served by
   ``ServingEngine.serve_latest`` to several client threads. Every response
   is checked against the plain forward (``use_pallas=False``) on the same
   weights on the card, and the kernel's launch count over the requests
   must equal the number of flushes.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero and prints no result. Every kernel's launch count is read
over main-path runs with the counts set to 0 just before each: the FM
kernels over the dense train task (``launches``), the sparse train tasks
and serving; the plan, take and segments kernels over the hashed sparse
train task (the take backward and segments also over the other three);
the install kernel over the tiered train task.

Numerics: float32 matmuls run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``) and bfloat16 matmuls
accumulate without reduced-precision reductions
(``allow_bf16_reduced_precision_reduction = False``); the serve tolerance
below assumes both.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from deepfm_tpu_torch import _native, launch  # noqa: E402
from deepfm_tpu_torch.config import Config  # noqa: E402
from deepfm_tpu_torch.data import libsvm  # noqa: E402
from deepfm_tpu_torch.models import get_model  # noqa: E402
from deepfm_tpu_torch.obs import trace as trace_lib  # noqa: E402
from deepfm_tpu_torch.ops import embedding as emb_ops  # noqa: E402
from deepfm_tpu_torch.ops import embedding_kernels as ek  # noqa: E402
from deepfm_tpu_torch.ops import fused_fm as ffm  # noqa: E402
from deepfm_tpu_torch.ops.fused_fm import fused_fm, reference_fm  # noqa: E402
from deepfm_tpu_torch.serve import ServingEngine  # noqa: E402
from deepfm_tpu_torch.train import Trainer, tasks  # noqa: E402
from deepfm_tpu_torch.utils import export as export_lib  # noqa: E402

SEED = 0

# Published peaks of one H100 SXM (NVIDIA data sheet), at a 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# fused_fm vs reference_fm: both convert to float32 after the load and sum
# in float32, in another order; the tolerance of tests/test_pallas_fm.py.
FM_RTOL, FM_ATOL = 1e-4, 1e-3
# The forward's vector path (16-byte chunks) at the reference width, at
# K = 8 and 64 (2 and 16 chunks a field in float32, 1 and 8 in bfloat16)
# and at F = 1; its scalar path at K = 33 and 48 (a field's bytes not a
# divisor of 512 in 16-byte chunks).
FM_CASES = [(b, 39, 32) for b in (1, 7, 256, 1024)] + [
    (256, 13, 8), (256, 39, 48), (7, 39, 33), (257, 39, 33), (3, 1, 64),
    (257, 39, 64), (257, 1, 8)]
# xv one element past a 16-byte boundary: the scalar path at the shapes the
# vector path takes (and so the previous design's time at them).
FM_MISALIGNED_CASES = [(b, 39, 32) for b in (1, 7, 256, 1024)]
TIMED_SHAPE = (256, 39, 32)  # one full serving flush (serve_max_batch)

# Backward kernel vs reference_fm_bwd: one float32 sum over F (in another
# order) then elementwise float32 products; float32 cotangents agree to
# 1e-5 relative. bfloat16 cotangents are rounded from float32 on both
# sides, so a value at a rounding boundary can land one bf16 ulp apart
# (at most 2^-7 of its magnitude).
BWD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
BWD_CASES = [(b, 39, 32) for b in (1, 7, 1024, 4096)] + [(1024, 13, 8),
                                                         (1024, 39, 48)]
TRAIN_SHAPE = (1024, 39, 32)  # one training batch at the reference width

# Train parity, kernels vs plain path, 20 steps at lr 5e-4. They differ
# only in float32 sum order (the FM reductions; both sum the embedding
# gradients in position order) until a bfloat16 tower rounds an input one
# ulp apart; between the JAX package and the port on the CPU the same bf16
# trajectory agreed to 2e-5 per step (tests/test_torch_train.py).
PARITY_STEPS = 20
PARITY_LOSS_ATOL = 1e-3

# Same-seed determinism: the layouts whose embedding gradient sums the
# cotangents of repeated ids, each trained twice for 20 steps.
DETERMINISM_STEPS = 20
DETERMINISM_LAYOUTS = {
    "dense": {},
    "sparse_monolithic": dict(embedding_update="sparse"),
    "dense_hashed": dict(embedding_buckets="262144,262144,262144,262144",
                         embedding_assign="hash"),
}

# Train phases: the reference width with 64 Ki train and 8 Ki eval records,
# decoded per record in Python on the pipeline's prefetch thread.
TRAIN_FILES, TRAIN_PER_FILE, EVAL_RECORDS = 8, 8192, 8192
TRAIN_EPOCHS = 2

# The sparse update's two layouts at the reference width. Hashed: the
# repo's own hashed shape, 4 tables x 262,144 buckets (scripts/
# bench_embedding.py), ids assigned to tables by hash.
SPARSE_LAYOUTS = {
    "sparse_monolithic": dict(embedding_update="sparse"),
    "sparse_hashed": dict(embedding_update="sparse",
                          embedding_buckets="262144,262144,262144,262144",
                          embedding_assign="hash"),
}
HASHED_TABLES = 4
EMB_PARAMS = 2  # fm_w, fm_v

# Plan and take kernels: one hashed table's view of a training batch.
PLAN_N = 1024 * 39
HASHED_ROWS = 262_144
MONO_ROWS = 117_632
PLAN_CASES = [  # (label, ids, rows, share of positions at the fill id)
    ("hashed_table", PLAN_N, HASHED_ROWS, 0.75),
    ("monolithic", PLAN_N, MONO_ROWS, 0.0),
    ("n1", 1, HASHED_ROWS, 0.0),
    ("all_equal", PLAN_N, HASHED_ROWS, "equal"),
    ("all_fill", PLAN_N, HASHED_ROWS, 1.0),
    ("n_gt_rows", PLAN_N, 4096, "every_row"),
    ("rows_2m", PLAN_N, 2_000_000, 0.0),
    # More ids than one pass of a CTA's threads holds (N / 8 > 8 * 1024):
    # the plan kernel's multi-pass marking and inv loop.
    ("batch_4096_hashed", 4096 * 39, HASHED_ROWS, 0.75),
    ("batch_4096_monolithic", 4096 * 39, MONO_ROWS, 0.0),
]
# One plan launch over tables of unequal rows (the smallest and the largest
# the counting plan takes, 3/4 of each table's positions at its fill id).
MIXED_ROWS = (HASHED_ROWS, 4096, 1, 2_000_000)
# The previous plan design's single-table time at the hashed shape (a memset
# and five dependent kernels per table), as PERF.md records it for an H100
# 80GB HBM3 at 700 W: printed beside the one-launch design's times as a
# recorded figure, never as a number of this run.
FIVE_PASS_PLAN_MS = 0.013058
# The previous take-backward design's time per table launch at the hashed
# shape (one thread per element, one launch per table), as PERF.md records
# it for an H100 80GB HBM3 at 700 W: printed beside the one-launch design's
# times as a recorded figure, never as a number of this run.
PREV_TAKE_BWD_MS = {1: 0.001961, 32: 0.005849}
# The take backward against the plain backward on the card: a float32 sum
# of the same terms that autograd's accumulate may take in another order;
# at most a few dozen terms per slot here, so within 1e-5 of the value.
TAKE_BWD_TOL = dict(rtol=1e-5, atol=1e-5)
# Sparse train parity (hashed, kernels vs plain legs): the take backward
# and plan are bit-equal across legs; the fused FM's float32 sum order and
# the bf16 tower differ as in the dense parity.
SPARSE_PARITY_LOSS_ATOL = 1e-3

# The hot/cold tier at the reference width: 81,920 hot rows hold about 2.4
# batches' unique ids (one B=1024 batch touches ~33.9k of the 117,581), the
# ratio of the repo's own tiered bench (24,576 hot rows over ~10k unique
# ids, scripts/bench_embedding.py). One batch per dispatch: a group of 8
# would touch ~93% of the ids, and the config keeps hot rows below the
# vocabulary.
TIERED = dict(embedding_update="sparse", embedding_tiering="hot_cold",
              embedding_hot_rows=81_920, steps_per_loop=1, transfer_ahead=2)
# Tiered parity (20 steps through fit, dropout off): the tier moves where
# rows live, never their values, and the install legs are bit-identical,
# so the runs differ only where a fused embedding backward adds a row's
# cotangents with float atomics (the ``xla`` leg's ``index_add_``, in
# another order from run to run; the kernel legs add in position order),
# which the bf16 tower can carry into a one-ulp rounding flip, as in the
# sparse parity above. Lazy Adam moves a touched row by
# lr * m / (sqrt(v) + eps): a gradient a few ulps apart moves that step by
# a few ulps of it, and a bf16 flip moves it by ~1e-3 of lr. The tables are
# held within lr / 5 = 1e-4 (an H100 run measured 5.4e-9), 40x below the
# tables' glorot scale (~4e-3), which one misplaced row would show.
TIER_PARITY_LOSS_ATOL = 1e-3
TIER_PARITY_TABLE_ATOL = 1e-4
# Install kernel: hot tables of 81,920 rows; one transaction of 10,000
# installs (about one batch's misses), padded to the next power of two.
INSTALL_H = 81_920
INSTALL_I = 10_000
INSTALL_P = 16_384
INSTALL_ARGS = ("w", "m", "v", "tau", "slots", "wv", "mv", "vv", "tv")
# The tier's two tables, which share one transaction's slots: fm_w (the 1-D
# table) and fm_v at the reference width.
INSTALL_WIDTHS = (1, 32)
# The previous install design's time per table launch at this shape (one
# thread per element, one launch per table), as PERF.md records it for an
# H100 80GB HBM3 at 700 W: printed as a recorded figure, never as a number
# of this run.
PREV_INSTALL_MS = {1: 0.002541, 32: 0.004340}

# Serve phase. Embedding tables are scaled up from their glorot init so the
# FM term moves probabilities well away from 0.5: a wrong kernel then shows
# in the responses. Served and reference probabilities differ only by the
# bfloat16 tower's rounding (the GEMMs run at the bucket's batch size vs
# the request's; a flip of one bf16 ulp of a logit near 1 is 2^-8, at most
# 1e-3 in probability) and float32 sum order in the FM term.
EMB_SCALE = 25.0
SERVE_ATOL = 5e-3
REQUEST_SIZES = (1, 3, 17, 64, 200, 256)
N_REQUESTS = 384
N_CLIENTS = 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call of ``fn`` on the device timeline (CUDA events around
    ``iters`` back-to-back calls, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 50):
    """(ms of device activity per call, device events per call) of ``fn``,
    from torch.profiler's CUDA events; (None, 0) when the profiler records
    no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans or sum(spans) <= 0:
        return None, 0
    return sum(spans) / 1000.0 / iters, len(spans) / iters


def fm_inputs(b, f, k, dtype, seed, misaligned: bool = False):
    """w, vals [B,F] and xv [B,F,K] on the card; ``misaligned`` puts xv one
    element past the start of its buffer (no 16-byte chunks)."""
    g = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        g.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    xv = mk(b, f, k)
    if misaligned:
        buf = torch.empty(xv.numel() + 1, dtype=dtype, device="cuda")
        buf[1:].copy_(xv.reshape(-1))
        xv = buf[1:].view(b, f, k)
        assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    return mk(b, f), mk(b, f), xv


def fm_bound(b, f, k, itemsize):
    """(bound_ms, bound_by): each input read once, the output written once,
    over HBM bandwidth; vs ~3 flops per xv element and 2 per w element over
    the float32 rate."""
    nbytes = b * f * (k + 2) * itemsize + 4 * b
    flops = b * f * (3 * k + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase():
    max_err = 0.0
    cases = [(c, False) for c in FM_CASES] + [
        (c, True) for c in FM_MISALIGNED_CASES]
    for dtype in (torch.float32, torch.bfloat16):
        for i, ((b, f, k), misaligned) in enumerate(cases):
            w, vals, xv = fm_inputs(b, f, k, dtype, SEED + i, misaligned)
            got = fused_fm(w, vals, xv)
            want = reference_fm(w, vals, xv)
            torch.cuda.synchronize()
            assert got.shape == (b,) and got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=FM_RTOL, atol=FM_ATOL)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            print(f"fused_fm check dtype={str(dtype)[6:]} B={b} F={f} K={k}"
                  f"{' xv misaligned (scalar path)' if misaligned else ''} "
                  f"max_abs_err={err:.3e}")

    # Two times per call: the device time of its kernels (torch.profiler),
    # which is what the bound compares with, and the per-call time on the
    # device timeline of back-to-back calls (CUDA events), which includes
    # the host's launch cost between kernels. Each shape also through the
    # scalar path (xv misaligned: the previous design), in turns with the
    # vector path.
    timing = {}
    for b in (1, 7, 256, 1024):
        f, k = TIMED_SHAPE[1:]
        w, vals, xv = fm_inputs(b, f, k, torch.float32, SEED)
        _, _, xv_off = fm_inputs(b, f, k, torch.float32, SEED, True)
        kern_call = cuda_ms(lambda: fused_fm(w, vals, xv))
        plain_call = cuda_ms(lambda: reference_fm(w, vals, xv))
        kern = device_profile(lambda: fused_fm(w, vals, xv))[0]
        plain = device_profile(lambda: reference_fm(w, vals, xv))[0]
        scalar = [device_profile(lambda: fused_fm(w, vals, xv_off))[0],
                  device_profile(lambda: fused_fm(w, vals, xv))[0],
                  device_profile(lambda: fused_fm(w, vals, xv_off))[0]]
        source = "profiler"
        if kern is None or plain is None or None in scalar:
            kern, plain, source = kern_call, plain_call, "cuda_events"
            scalar = [cuda_ms(lambda: fused_fm(w, vals, x))
                      for x in (xv_off, xv, xv_off)]
        bound, bound_by = fm_bound(b, f, k, 4)
        timing[(b, f, k)] = (kern, plain, bound, bound_by, source)
        print(f"fused_fm time f32 B={b} F={f} K={k}: kernel_ms={kern:.6f} "
              f"plain_ms={plain:.6f} ({source}) kernel_call_ms={kern_call:.6f} "
              f"plain_call_ms={plain_call:.6f} (cuda_events) "
              f"bound_ms={bound:.6f} ({bound_by}: HBM "
              f"{HBM_BYTES_PER_S / 1e12} TB/s, f32 "
              f"{F32_FLOPS_PER_S / 1e12} TFLOP/s); turns scalar/vector/"
              f"scalar: {scalar[0]:.6f} {scalar[1]:.6f} {scalar[2]:.6f} "
              f"({source})")
    print("fused_fm library_ms: none (no single PyTorch call computes the "
          "fused first+second order FM)")
    return max_err, timing


def bwd_bound(b, f, k, itemsize):
    """(bound_ms, bound_by) of the backward: w, vals, xv and g read once,
    dw, dvals, dxv written once, over HBM bandwidth; vs ~2 flops per
    output element over the float32 rate."""
    nbytes = 2 * b * f * (k + 2) * itemsize + 4 * b
    flops = b * f * (2 * k + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bwd_phase():
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, f, k) in enumerate(BWD_CASES):
            w, vals, xv = fm_inputs(b, f, k, dtype, SEED + 100 + i)
            g = torch.randn(b, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(i))
            got = ffm._launch_bwd(g, w, vals, xv)
            want = ffm.reference_fm_bwd(g, w, vals, xv)
            torch.cuda.synchronize()
            for name, gt, wt, prim in zip(("dw", "dvals", "dxv"), got, want,
                                          (w, vals, xv)):
                assert gt.dtype == wt.dtype == prim.dtype, (name, gt.dtype)
                assert gt.shape == prim.shape, (name, gt.shape)
                torch.testing.assert_close(gt, wt, **BWD_TOL[dtype])
                max_err = max(max_err, float((gt.float() - wt.float())
                                             .abs().max()))
            # autograd through the kernels vs through the plain forward
            tw, tv, tx = (t.clone().requires_grad_() for t in (w, vals, xv))
            kern = torch.autograd.grad(fused_fm(tw, tv, tx), (tw, tv, tx), g)
            plain = torch.autograd.grad(reference_fm(tw, tv, tx),
                                        (tw, tv, tx), g)
            torch.cuda.synchronize()
            for kt, pt in zip(kern, plain):
                assert kt.dtype == pt.dtype == dtype
                torch.testing.assert_close(kt, pt, **BWD_TOL[dtype])
            print(f"fused_fm_bwd check dtype={str(dtype)[6:]} B={b} F={f} "
                  f"K={k} grads ok, autograd ok")

    b, f, k = TRAIN_SHAPE
    w, vals, xv = fm_inputs(b, f, k, torch.float32, SEED)
    g = torch.randn(b, device="cuda")
    kern_call = cuda_ms(lambda: ffm._launch_bwd(g, w, vals, xv))
    plain_call = cuda_ms(lambda: ffm.reference_fm_bwd(g, w, vals, xv))
    kern = device_profile(lambda: ffm._launch_bwd(g, w, vals, xv))[0]
    plain = device_profile(lambda: ffm.reference_fm_bwd(g, w, vals, xv))[0]
    source = "profiler"
    if kern is None or plain is None:
        kern, plain, source = kern_call, plain_call, "cuda_events"
    bound, bound_by = bwd_bound(b, f, k, 4)
    print(f"fused_fm_bwd time f32 B={b} F={f} K={k}: kernel_ms={kern:.6f} "
          f"plain_ms={plain:.6f} ({source}) kernel_call_ms={kern_call:.6f} "
          f"plain_call_ms={plain_call:.6f} (cuda_events) "
          f"bound_ms={bound:.6f} ({bound_by}: HBM "
          f"{HBM_BYTES_PER_S / 1e12} TB/s)")
    print("fused_fm_bwd library_ms: none (no single PyTorch call computes "
          "the FM cotangents)")
    return max_err, (kern, plain, bound, bound_by, source)


def timed(fn, iters: int = 200):
    """(device ms per call from the profiler, or the CUDA-event call time
    when the profiler records none; call ms; source)."""
    call = cuda_ms(fn, iters=iters)
    dev_ms = device_profile(fn)[0]
    if dev_ms is None:
        return call, call, "cuda_events"
    return dev_ms, call, "profiler"


def bound_of(nbytes: int, ops: int):
    """(bound_ms, bound_by): bytes over the HBM rate vs operations over
    the float32 (non-tensor-core) rate, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plan_case_ids(n: int, rows: int, kind, rng) -> np.ndarray:
    if kind == "equal":
        return np.full(n, rows // 3, np.int32)
    if kind == "every_row":
        ids = np.concatenate([np.arange(rows), rng.integers(0, rows,
                                                            n - rows)])
        return rng.permutation(ids).astype(np.int32)
    ids = rng.integers(0, rows, n).astype(np.int32)
    ids[rng.random(n) < kind] = rows
    return ids


def hashed_step_ids(rng, t: int = HASHED_TABLES):
    """The hashed step's view of one batch: every position reads exactly
    one of ``t`` tables of HASHED_ROWS rows (drawn uniformly, as the id
    hash assigns them), and the other tables see their fill id there.
    Returns (ids int32 [t, N], masks float32 [t, N])."""
    owner = rng.integers(0, t, PLAN_N)
    ids = rng.integers(0, HASHED_ROWS, (t, PLAN_N)).astype(np.int32)
    masks = (owner[None, :] == np.arange(t)[:, None])
    ids[~masks] = HASHED_ROWS
    return ids, masks.astype(np.float32)


def _check_plans(label: str, ids_list, rows_list) -> None:
    """One plan launch over the tables vs each table's plain version on the
    card and the numpy oracle."""
    dev = torch.device("cuda")
    on = [torch.from_numpy(x).to(dev) for x in ids_list]
    before = ek.plan_launches
    got = ek.plan_build_tables(on, rows_list)
    assert ek.plan_launches - before == 1
    for i, (ids, t, rows, g) in enumerate(zip(ids_list, on, rows_list, got)):
        want = emb_ops.make_plan_counting(t, rows)
        torch.cuda.synchronize()
        for f in ("uids", "inv", "touched"):
            assert torch.equal(getattr(g, f), getattr(want, f)), (label, i, f)
        assert torch.equal(g.rank[g.touched], want.rank[want.touched])
        uids, inv, touched, _ = ek.reference_plan_numpy(ids, rows)
        assert np.array_equal(g.uids.cpu().numpy(), uids), (label, i)
        assert np.array_equal(g.inv.cpu().numpy(), inv), (label, i)
        assert np.array_equal(g.touched.cpu().numpy(), touched), (label, i)
    print(f"plan check {label}: N={ids_list[0].size} rows={list(rows_list)} "
          f"uniques={[int((g.uids < r).sum()) for g, r in zip(got, rows_list)]}"
          f" in one launch, bit-equal to plain and oracle")


def plan_bound(tables: int, n: int = PLAN_N, rows: int = HASHED_ROWS):
    """Each input and output once, per table: ids, uids, inv (4N bytes
    each), touched (rows bytes), rank (4 rows bytes)."""
    nbytes = tables * (3 * 4 * n + rows + 4 * rows)
    return bound_of(nbytes, tables * (4 * n + 4 * rows)) + (nbytes,)


def plan_phase():
    """Plan kernel vs plain (and the numpy oracle) at every listed shape and
    over four tables of unequal rows in one launch; then times of one
    table's launch and of the hashed step's four-table launch."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 20)
    for label, n, rows, kind in PLAN_CASES:
        _check_plans(label, [plan_case_ids(n, rows, kind, rng)], [rows])
    _check_plans("mixed_4_tables",
                 [plan_case_ids(PLAN_N, r, 0.75, rng) for r in MIXED_ROWS],
                 MIXED_ROWS)

    ids, _ = hashed_step_ids(rng)
    rows4 = [HASHED_ROWS] * HASHED_TABLES
    _check_plans("hashed_4_tables", list(ids), rows4)
    t4 = torch.from_numpy(ids).to(dev)
    # The four tables' id spaces laid end to end, so that one torch.unique
    # dedups every table at once.
    offsets = torch.arange(HASHED_TABLES, device=dev)[:, None] * (
        HASHED_ROWS + 1)
    joint = (t4 + offsets).reshape(-1)
    timing = {}
    for tables, kern_fn, plain_fn, lib_fn in (
            (1, lambda: ek.plan_build_tables(t4[:1], rows4[:1]),
             lambda: emb_ops.make_plan_counting(t4[0], HASHED_ROWS),
             lambda: torch.unique(t4[0], sorted=True, return_inverse=True)),
            (HASHED_TABLES, lambda: ek.plan_build_tables(t4, rows4),
             lambda: [emb_ops.make_plan_counting(x, HASHED_ROWS)
                      for x in t4],
             lambda: torch.unique(joint, sorted=True, return_inverse=True))):
        kern, kern_call, source = timed(kern_fn)
        plain, plain_call, _ = timed(plain_fn)
        lib, lib_call, _ = timed(lib_fn)
        bound, bound_by, nbytes = plan_bound(tables)
        timing[tables] = (kern, plain, lib, bound, bound_by, source)
        print(f"plan time T={tables} N={PLAN_N} rows={HASHED_ROWS} (one "
              f"launch): kernel_ms={kern:.6f} plain_ms={plain:.6f} "
              f"library_ms(torch.unique, one call)={lib:.6f} ({source}) "
              f"kernel_call_ms={kern_call:.6f} plain_call_ms="
              f"{plain_call:.6f} library_call_ms={lib_call:.6f} "
              f"(cuda_events) bound_ms={bound:.6f} ({bound_by}: {nbytes} B)"
              f"; recorded, not this run: five-pass design "
              f"{FIVE_PASS_PLAN_MS * tables:.6f} ms for {tables} table"
              f"{'s' if tables > 1 else ''} (PERF.md)")
    # The design's fixed cost: one table of one row and one id (the cluster
    # launch, its barriers and DSMEM round trips, almost no bytes).
    one = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    floor, floor_call, source = timed(lambda: ek.plan_build_tables(one, [1]))
    timing["floor"] = floor
    print(f"plan_floor T=1 N=1 rows=1: kernel_ms={floor:.6f} ({source}) "
          f"kernel_call_ms={floor_call:.6f} (cuda_events)")
    return timing


def take_bound(n: int, d: int, ref_rows, masked: bool):
    """Each input and output once: inv (and masks) per table, each
    referenced row once, the output [N, D]; a product per table (with
    masks) and an add per further table for each output element."""
    t = len(ref_rows)
    nbytes = sum(4 * n * (2 if masked else 1) + 4 * d * r for r in ref_rows)
    ops = ((t if masked else 0) + t - 1) * d * n
    return bound_of(nbytes + 4 * d * n, ops)


def segments_phase(plans):
    """The hashed step's position segments, built by the plain versions per
    table (``reference_position_segments``, a sort each) and for the four
    tables at once (``reference_position_segments_tables``, one sort over a
    composite key), and by the segments kernel in one launch
    (``position_segments_tables``, as ``sparse_plan`` does): bit-equal;
    then the device ms and events of each build."""
    n = PLAN_N
    inv = torch.stack([p.inv for p in plans])
    keep = torch.stack([p.mask > 0 for p in plans])
    per_table = lambda: [ek.reference_position_segments(  # noqa: E731
        p.inv, n, keep=p.mask > 0) for p in plans]
    batched = lambda: ek.reference_position_segments_tables(  # noqa: E731
        inv, n, keep)
    kernel = lambda: ek.position_segments_tables(inv, n, keep)  # noqa: E731
    for (o1, s1), (o2, s2), (o3, s3) in zip(per_table(), batched(),
                                            kernel()):
        assert torch.equal(o1, o2) and torch.equal(s1, s2)
        assert torch.equal(o1, o3) and torch.equal(s1, s3)
    out = {}
    for turn in range(2):
        for name, fn in (("per_table", per_table), ("batched", batched),
                         ("kernel", kernel)):
            ms, events = device_profile(fn)
            call = cuda_ms(fn, iters=100)
            out.setdefault(name, []).append((ms, events, call))
            print(f"segments build T={len(plans)} N={n} {name}: "
                  f"device_ms={ms if ms is None else f'{ms:.6f}'} "
                  f"device_events={events:g} call_ms={call:.6f} "
                  f"(cuda_events)")
    print("segments check: the plain batched build and the kernel's one "
          "launch are bit-equal to the plain per-table builds")
    return {k: v[0] for k, v in out.items()}


def segments_oracle(inv: np.ndarray, u: int, keep):
    """numpy oracle of one table's segments: the stable argsort of the keys
    (inv, or u where left out or outside [0, u)) and the searchsorted
    starts of the slots 0..u."""
    ok = (inv >= 0) & (inv < u)
    if keep is not None:
        ok &= keep
    key = np.where(ok, inv, u)
    order = np.argsort(key, kind="stable").astype(np.int32)
    starts = np.searchsorted(key[order], np.arange(u + 1), side="left")
    return order, starts.astype(np.int32)


def zipf_ids(rng, shape, u: int) -> np.ndarray:
    """Zipf (s = 1.1) ids below u, the tail clipped to u - 1: a few hot
    slots hold thousands of positions, as Criteo's ids do."""
    return np.minimum(rng.zipf(1.1, shape) - 1, u - 1)


def segment_cases(rng):
    """(label, inv [T, N] numpy int32 or int64, slot counts, keep [T, N]
    or None): every run length the kernel treats apart (one position, a
    thread's sort, a block's sort, a long run's compaction), the left-out
    tail, T = 1..8 tables of unequal slot counts, and the edges."""
    n = PLAN_N
    i32 = np.int32
    fill = rng.integers(0, n, (1, n)).astype(i32)
    fill[rng.random((1, n)) < 0.75] = n - 1
    cases = [
        ("uniform", rng.integers(0, n, (1, n)).astype(i32), [n], None),
        ("zipf_vocab", zipf_ids(rng, (1, n), MONO_ROWS), [MONO_ROWS], None),
        ("zipf_hashed_keep", zipf_ids(rng, (4, n), n).astype(i32), [n] * 4,
         rng.random((4, n)) < 0.25),
        ("all_one_slot", np.full((1, n), 7, i32), [1000], None),
        ("fill_slot_no_keep", fill, [n], None),
        ("medium_runs", rng.integers(0, 200, (1, n)).astype(i32), [200],
         None),
        ("n1", np.zeros((1, 1), i32), [HASHED_ROWS], None),
        ("n1_left_out", np.full((1, 1), 5, i32), [HASHED_ROWS],
         np.zeros((1, 1), bool)),
        ("n0", np.zeros((2, 0), i32), [3, 4], None),
        ("u_much_larger", rng.integers(0, 2_000_000, (1, 1000)),
         [2_000_000], None),
        ("u1", np.zeros((1, n), i32), [1], None),
        ("u0", rng.integers(-3, 3, (1, 100)).astype(i32), [0], None),
        ("out_of_range", rng.integers(-5, 105, (2, 999)), [100, 50],
         rng.random((2, 999)) < 0.5),
        ("batch_4096_keep", rng.integers(0, 4096 * 39, (4, 4096 * 39)
                                         ).astype(i32), [4096 * 39] * 4,
         rng.random((4, 4096 * 39)) < 0.25),
    ]
    for t in range(1, ek.MAX_TABLES + 1):
        keep = rng.random((t, n)) < 0.5 if t % 2 else None
        cases.append((f"tables_{t}", rng.integers(0, 5000, (t, n)).astype(
            i32), [5000 + 7 * i for i in range(t)], keep))
    return cases


def segments_bound(inv: torch.Tensor, slots, keep):
    """Each input and output once: inv and keep read, order and every
    table's starts written; a few integer operations per position."""
    t, n = inv.shape
    nbytes = inv.numel() * inv.element_size() + 4 * t * n
    nbytes += 4 * sum(u + 1 for u in slots)
    if keep is not None:
        nbytes += keep.numel()
    return bound_of(nbytes, 0) + (nbytes,)


def segments_kernel_phase():
    """The segments kernel (``dfm_segments``, one launch for 1 to 8
    tables) against its plain version on the card and the numpy oracle,
    bit for bit, on every case of ``segment_cases``; then, at the main
    path's shapes, its time and device events beside the plain version's,
    one ``torch.sort`` + ``searchsorted`` over precomputed composite keys
    (the library yardstick) and the bound. Returns the timings."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 60)
    for label, inv_np, slots, keep_np in segment_cases(rng):
        inv = torch.from_numpy(inv_np).to(dev)
        keep = None if keep_np is None else torch.from_numpy(keep_np).to(dev)
        before = ek.segments_launches
        got = ek.position_segments_tables(inv, slots, keep)
        assert ek.segments_launches - before == 1, label
        again = ek.position_segments_tables(inv, slots, keep)
        want = ek.reference_position_segments_tables(inv, slots, keep)
        torch.cuda.synchronize()
        longest = 0
        for i, ((o, st), (o2, st2), (wo, ws)) in enumerate(zip(got, again,
                                                              want)):
            assert torch.equal(o, wo) and torch.equal(st, ws), (label, i)
            assert torch.equal(o, o2) and torch.equal(st, st2), (label, i)
            oo, os_ = segments_oracle(inv_np[i], slots[i],
                                      None if keep_np is None else keep_np[i])
            assert np.array_equal(o.cpu().numpy(), oo), (label, i)
            assert np.array_equal(st.cpu().numpy(), os_), (label, i)
            if os_.size:
                runs = np.diff(np.append(os_, inv_np.shape[1]))
                longest = max(longest, int(runs.max()))
        print(f"segments check {label} T={inv.shape[0]} N={inv.shape[1]} "
              f"U={slots if len(set(slots)) > 1 else slots[0]} "
              f"{str(inv.dtype)[6:]} keep={keep is not None} longest run "
              f"{longest}: one launch, bit-equal to the plain version on the "
              f"card, to its second launch and to the numpy oracle")

    gen = np.random.default_rng(SEED + 61)
    ids, masks = hashed_step_ids(gen)
    plans = ek.plan_build_tables(
        torch.from_numpy(ids).to(dev), [HASHED_ROWS] * HASHED_TABLES,
        [torch.from_numpy(m).to(dev) for m in masks])
    vocab = torch.from_numpy(gen.integers(0, MONO_ROWS - 51, (1, PLAN_N))
                             ).to(dev)
    shapes = {
        "hashed": (torch.stack([p.inv for p in plans]), [PLAN_N] * 4,
                   torch.stack([p.mask > 0 for p in plans])),
        "vocab": (vocab, [MONO_ROWS], None),
        "fused_leg": (vocab, [MONO_ROWS + 1], None),
        "dense_hashed": (torch.from_numpy(gen.integers(
            0, HASHED_ROWS, (HASHED_TABLES, PLAN_N))).to(dev),
            [HASHED_ROWS] * HASHED_TABLES, None),
    }
    timing = {}
    for label, (inv, slots, keep) in shapes.items():
        t, n = inv.shape
        stride = slots[0] + 1
        keys = ek._segment_keys(inv, slots[0], keep) + torch.arange(
            0, t * stride, stride, dtype=torch.int32, device=dev)[:, None]
        keys = keys.reshape(-1)
        bounds = torch.arange(t * stride, dtype=torch.int32, device=dev)

        def lib():
            sk, order = torch.sort(keys, stable=True)
            return order, torch.searchsorted(sk, bounds, out_int32=True)

        kern_fn = lambda: ek.position_segments_tables(  # noqa: E731
            inv, slots, keep)
        plain_fn = lambda: ek.reference_position_segments_tables(  # noqa: E731
            inv, slots, keep)
        kern = timed(kern_fn)
        plain = timed(plain_fn)
        libt = timed(lib)
        events = [device_profile(f)[1] for f in (kern_fn, plain_fn, lib)]
        bound = segments_bound(inv, slots, keep)
        timing[label] = (kern, plain, libt, bound, events)
        print(f"segments time {label} T={t} N={n} U={slots[0]} "
              f"{str(inv.dtype)[6:]} keep={keep is not None}: "
              f"kernel_ms={kern[0]:.6f} plain_ms={plain[0]:.6f} "
              f"library_ms(torch.sort + searchsorted)={libt[0]:.6f} "
              f"({kern[2]}) kernel_call_ms={kern[1]:.6f} plain_call_ms="
              f"{plain[1]:.6f} library_call_ms={libt[1]:.6f} (cuda_events) "
              f"device_events kernel/plain/library={events[0]:g}/"
              f"{events[1]:g}/{events[2]:g} bound_ms={bound[0]:.6f} "
              f"({bound[1]}: {bound[2]} B)")
    return timing


def take_bwd_oracle(g: torch.Tensor, inv: torch.Tensor, keep, u: int):
    """numpy ascending-p segment sum: d[u] = sum of g[p] over the kept
    positions p with inv[p] = u, from 0.0 (``np.add.at`` adds in order)."""
    gg, iv = g.cpu().numpy(), inv.cpu().numpy()
    if keep is not None:
        k = keep.cpu().numpy()
        gg, iv = gg[k], iv[k]
    out = np.zeros((u,) + gg.shape[1:], gg.dtype)
    np.add.at(out, iv, gg)
    return out


def take_bwd_bound(g_cols: int, kept, num_slots, itemsize: int = 4):
    """Each input and output once: the kept positions' cotangent rows and
    order entries, every table's starts, and every table's [U_t, D]
    output; one add per kept element."""
    nbytes = sum(itemsize * g_cols * k + 4 * k for k in kept)
    nbytes += sum(4 * (u + 1) + itemsize * g_cols * u for u in num_slots)
    return bound_of(nbytes, sum(kept) * g_cols) + (nbytes,)


def take_tables_phase():
    """The fused forward over the hashed step's four masked tables (one
    plan launch over them), bit-equal to the plain composition at D = 1
    and 32; the one-launch backward over the four tables bit-equal to the
    numpy oracle, to its second launch and to one launch per table, and
    the gradients through ``TakeRowsSum`` (one backward launch) bit-equal
    to it; the segments' build per table and batched; then the times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    ids, masks = hashed_step_ids(np.random.default_rng(SEED + 33))
    plans = ek.plan_build_tables(
        torch.from_numpy(ids).to(dev), [HASHED_ROWS] * HASHED_TABLES,
        [torch.from_numpy(m).to(dev) for m in masks])
    n = PLAN_N
    inv = [p.inv for p in plans]
    mk = [p.mask for p in plans]
    keep = [p.mask > 0 for p in plans]
    seg_t = segments_phase(plans)
    segs = ek.position_segments_tables(torch.stack(inv), n,
                                       torch.stack(keep))
    ref_rows = [int((p.uids < HASHED_ROWS).sum()) + 1 for p in plans]
    kept = [int(k.sum()) for k in keep]
    slots = [n] * HASHED_TABLES
    timing = {}
    for d in (1, 32):
        # As gather_rows hands them over: the fill slots read zero.
        rows = [torch.where((p.uids < HASHED_ROWS)[:, None], torch.randn(
            n, d, device=dev, generator=gen), 0.0) for p in plans]
        g = torch.randn(n, d, device=dev, generator=gen)
        out = ek._launch_take_fwd(rows, inv, mk)
        want = ek.reference_take_sum(rows, inv, mk)
        torch.cuda.synchronize()
        assert torch.equal(out, want), d
        before = ek.take_bwd_launches
        bwd = ek._launch_take_bwd_tables(g, segs, slots)
        again = ek._launch_take_bwd_tables(g, segs, slots)
        assert ek.take_bwd_launches - before == 2
        for i in range(HASHED_TABLES):
            one = ek._launch_take_bwd(g, segs[i], n)
            torch.cuda.synchronize()
            assert torch.equal(bwd[i], again[i]), (d, i)
            assert torch.equal(bwd[i], one), (d, i)
            assert np.array_equal(bwd[i].cpu().numpy(), take_bwd_oracle(
                g, inv[i], keep[i], n)), (d, i)
        leaves = [r.clone().requires_grad_() for r in rows]
        before = ek.take_fwd_launches, ek.take_bwd_launches
        view = ek.take_rows_sum(leaves, inv, mk, segs)
        grads = torch.autograd.grad(view, leaves, g)
        assert (ek.take_fwd_launches - before[0],
                ek.take_bwd_launches - before[1]) == (1, 1)
        for i, gr in enumerate(grads):
            assert torch.equal(gr, bwd[i]), (d, i)
        print(f"take check T={HASHED_TABLES} masked D={d}: forward one "
              f"launch, bit-equal to the plain composition; backward one "
              f"launch for the {HASHED_TABLES} tables, bit-equal to the "
              f"numpy ascending-p oracle, to its second launch and to one "
              f"launch per table; TakeRowsSum gradients (one launch each "
              f"way) bit-equal")

        # The library's one call for the same backward: one index_add_
        # over the four tables' outputs end to end, each table's inv offset
        # by t * N and its masked positions sent to a dropped last row
        # (built outside the timing). Its atomics may add in another order.
        joint = torch.cat([torch.where(k, v.long() + i * n, HASHED_TABLES * n)
                           for i, (v, k) in enumerate(zip(inv, keep))])
        g_rep = g.repeat(HASHED_TABLES, 1)
        lib_bwd = lambda: torch.zeros(  # noqa: E731
            HASHED_TABLES * n + 1, d, device=dev).index_add_(0, joint, g_rep)
        torch.testing.assert_close(lib_bwd()[:-1], torch.cat(bwd),
                                   **TAKE_BWD_TOL)
        bwd_t = timed(lambda: ek._launch_take_bwd_tables(g, segs, slots))
        bwd_plain = timed(lambda: [ek.reference_take_bwd(
            g * m[:, None], v, n) for v, m in zip(inv, mk)])
        bwd_lib = timed(lib_bwd)
        bb = take_bwd_bound(d, kept, slots)
        timing[("take_bwd", HASHED_TABLES, d)] = (bwd_t, bwd_plain, bwd_lib,
                                                  bb[:2])
        print(f"take_bwd time T={HASHED_TABLES} masked D={d} N=U={n} (one "
              f"launch, kept positions {kept}): kernel_ms={bwd_t[0]:.6f} "
              f"plain_ms={bwd_plain[0]:.6f} library_ms(one index_add_ over "
              f"the tables end to end)={bwd_lib[0]:.6f} ({bwd_t[2]}) "
              f"kernel_call_ms={bwd_t[1]:.6f} plain_call_ms="
              f"{bwd_plain[1]:.6f} library_call_ms={bwd_lib[1]:.6f} "
              f"(cuda_events) bound_ms={bb[0]:.6f} ({bb[1]}: {bb[2]} B); "
              f"recorded, not this run: {HASHED_TABLES} launches x "
              f"{PREV_TAKE_BWD_MS[d]:.6f} ms (PERF.md)")

        # The library's one call for the same function: a sum bag of T
        # rows per position, the masks as per-sample weights, over the
        # tables concatenated (built once, outside the timing).
        joint = torch.cat(rows)
        first = [0]
        for r in rows[:-1]:
            first.append(first[-1] + r.shape[0])
        bag_ids = torch.stack([v.long() + o for v, o in zip(inv, first)], 1)
        bag_w = torch.stack(mk, 1)
        bag = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
            bag_ids, joint, mode="sum", per_sample_weights=bag_w)
        # One mask is 1 at each position and the others multiply the fill
        # slot's zero row, so any sum order gives the same value.
        torch.testing.assert_close(bag(), want, rtol=1e-6, atol=1e-6)
        fwd = timed(lambda: ek._launch_take_fwd(rows, inv, mk))
        plain = timed(lambda: ek.reference_take_sum(rows, inv, mk))
        lib = timed(bag)
        bound = take_bound(n, d, ref_rows, masked=True)
        timing[("take_fwd", HASHED_TABLES, d)] = (fwd, plain, lib, bound)
        print(f"take_fwd time T={HASHED_TABLES} masked D={d} N={n} "
              f"(referenced rows {ref_rows}): kernel_ms={fwd[0]:.6f} "
              f"plain_ms={plain[0]:.6f} library_ms(embedding_bag sum with "
              f"per-sample weights)="
              f"{lib[0]:.6f} ({fwd[2]}) kernel_call_ms={fwd[1]:.6f} "
              f"plain_call_ms={plain[1]:.6f} library_call_ms={lib[1]:.6f} "
              f"(cuda_events) bound_ms={bound[0]:.6f} ({bound[1]})")
    return timing, seg_t


def take_phase():
    """Take forward and backward kernels vs plain and the CPU oracle, at
    D = 1 and 32, U = N = 39,936: random slots (every run a few positions
    long) and one hashed table's plan (3/4 of the positions masked, as the
    train step feeds it), one table a launch; then the hashed step's four
    tables in one launch (``take_tables_phase``). Times at the hashed
    plan's shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    rng = np.random.default_rng(SEED + 31)
    n = PLAN_N
    ids = plan_case_ids(n, HASHED_ROWS, 0.75, rng)
    plan = ek.plan_build_kernel(torch.from_numpy(ids).to(dev), HASHED_ROWS)
    mask = (plan.uids.new_tensor(ids) < HASHED_ROWS).float()
    rand_inv = torch.from_numpy(rng.integers(0, n // 4, n).astype(np.int32)
                                ).to(dev)
    zipf_inv = torch.from_numpy(zipf_ids(rng, n, n).astype(np.int32)).to(dev)
    max_err, timing = 0.0, {}
    for d in (1, 32):
        rows = torch.randn(n, d, device=dev, generator=gen)
        g = torch.randn(n, d, device=dev, generator=gen)
        for label, inv, gg, keep in (
                ("random", rand_inv, g, None),
                ("zipf", zipf_inv, g, None),
                ("hashed_plan", plan.inv, g * mask[:, None], mask > 0)):
            out = ek._launch_take_fwd([rows], [inv])
            assert torch.equal(out, ek.reference_take(rows, inv)), (label, d)
            masked = ek._launch_take_fwd([rows], [inv], [mask])
            assert torch.equal(masked, ek.reference_take_sum(
                [rows], [inv], [mask])), (label, d)
            seg = ek.position_segments(inv, n, keep=keep)
            a = ek._launch_take_bwd(gg, seg, n)
            b = ek._launch_take_bwd(gg, seg, n)
            plain = ek.reference_take_bwd(gg, inv, n)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (label, d)
            oracle = np.zeros((n, d), np.float32)
            np.add.at(oracle, inv.cpu().numpy(), gg.cpu().numpy())
            assert np.array_equal(a.cpu().numpy(), oracle), (label, d)
            err = float((a - plain).abs().max())
            if label != "zipf":
                # TAKE_BWD_TOL covers runs of a few dozen terms; a Zipf
                # slot sums thousands, in another order on the plain side,
                # so that case is held bit for bit to the oracle above only.
                torch.testing.assert_close(a, plain, **TAKE_BWD_TOL)
                max_err = max(max_err, err)
            print(f"take check {label} D={d}: forward bit-equal, backward "
                  f"bit-equal to the CPU oracle and to its second launch, "
                  f"max |kernel - plain on card| {err:.3e}")
        # autograd through one masked table (the path lookup_rows takes)
        leaf = rows.clone().requires_grad_()
        seg = ek.position_segments(plan.inv, n, keep=mask > 0)
        view = ek.take_rows_sum([leaf], [plan.inv], [mask], [seg])
        d_rows, = torch.autograd.grad(view, leaf, g)
        assert torch.equal(d_rows, ek._launch_take_bwd(g * mask[:, None],
                                                       seg, n))

        inv, gg = plan.inv, g * mask[:, None]
        inv64 = inv.long()
        fwd = timed(lambda: ek._launch_take_fwd([rows], [inv]))
        fwd_plain = timed(lambda: ek.reference_take(rows, inv))
        fwd_lib = timed(lambda: rows.index_select(0, inv64))
        bwd = timed(lambda: ek._launch_take_bwd(gg, seg, n))
        bwd_plain = timed(lambda: ek.reference_take_bwd(gg, inv, n))
        bwd_lib = timed(lambda: torch.zeros(n, d, device=dev).index_add_(
            0, inv64, gg))
        # What this run's data needs: the forward reads inv, each referenced
        # row once and writes N rows; the backward reads the kept positions
        # (order and cotangent rows) and starts, and writes U rows.
        ref_rows = int((plan.uids < HASHED_ROWS).sum()) + 1
        kept = int((mask > 0).sum())
        fb = take_bound(n, d, [ref_rows], masked=False)
        bb = take_bwd_bound(d, [kept], [n])[:2]
        timing[("take_fwd", 1, d)] = (fwd, fwd_plain, fwd_lib, fb)
        timing[("take_bwd", 1, d)] = (bwd, bwd_plain, bwd_lib, bb)
        for name, (k, kc, src), (p, pc, _), (lb, lc, _), (bd, by) in (
                ("take_fwd", fwd, fwd_plain, fwd_lib, fb),
                ("take_bwd", bwd, bwd_plain, bwd_lib, bb)):
            lib_name = "index_select" if name == "take_fwd" else "index_add_"
            print(f"{name} time T=1 D={d} N=U={n} (hashed plan, {kept} kept "
                  f"positions, {ref_rows} referenced rows): kernel_ms={k:.6f} "
                  f"plain_ms={p:.6f} library_ms({lib_name})={lb:.6f} ({src}) "
                  f"kernel_call_ms={kc:.6f} plain_call_ms={pc:.6f} "
                  f"library_call_ms={lc:.6f} (cuda_events) bound_ms={bd:.6f} "
                  f"({by})")
    tables_t, seg_t = take_tables_phase()
    timing.update(tables_t)
    return max_err, timing, seg_t


def segment_sum_phase():
    """The position-order segment sum that replaces float atomics on the
    dense and the monolithic layouts (``ek.segment_sum``: one segments
    launch, then one take backward launch): one batch's ids over the padded
    vocabulary at
    the dense lookups' widths (D = 1, 32) and over the fused leg's rows + 1
    slots at its width (1 + 1 + 32 columns), bit-equal to the numpy
    ascending-p oracle and to its second call; then its time (segments
    build included) beside ``index_add_`` into zeros, the call it
    replaces."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 50)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    n = PLAN_N
    ids = torch.from_numpy(rng.integers(0, MONO_ROWS - 51, n)).to(dev)
    timing = {}
    for label, d, u in (("dense_fm_w", 1, MONO_ROWS),
                        ("dense_fm_v", 32, MONO_ROWS),
                        ("fused_leg", 2 + 32, MONO_ROWS + 1)):
        g = torch.randn(n, d, device=dev, generator=gen)
        before = ek.take_bwd_launches, ek.segments_launches
        a = ek.segment_sum(g, ids, u)
        b = ek.segment_sum(g, ids, u)
        assert (ek.take_bwd_launches - before[0],
                ek.segments_launches - before[1]) == (2, 2)
        torch.cuda.synchronize()
        assert torch.equal(a, b), label
        assert np.array_equal(a.cpu().numpy(), take_bwd_oracle(
            g, ids, None, u)), label
        lib = lambda: torch.zeros(u, d, device=dev).index_add_(  # noqa: E731
            0, ids, g)
        torch.testing.assert_close(lib(), a, **TAKE_BWD_TOL)
        kern = timed(lambda: ek.segment_sum(g, ids, u), iters=100)
        lib_t = timed(lib, iters=100)
        timing[label] = (kern, lib_t)
        print(f"segment_sum check {label} N={n} U={u} D={d}: bit-equal to "
              f"the numpy ascending-p oracle and to its second call; time "
              f"(segments + take backward launches) device_ms={kern[0]:.6f} "
              f"call_ms="
              f"{kern[1]:.6f}, library index_add_ device_ms={lib_t[0]:.6f} "
              f"call_ms={lib_t[1]:.6f} ({kern[2]})")
    return timing


def install_inputs(h: int, d: int, slots: np.ndarray, rng) -> dict:
    """Host arrays for one install: tables [H] (D = 1, the 1-D fm_w) or
    [H, D], tau [H], ``slots`` and values for every slot (the padding's
    values too, so a dropped slot that was written would show)."""
    p = slots.size
    t_shape = (h,) if d == 1 else (h, d)
    v_shape = (p,) if d == 1 else (p, d)
    f = lambda s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return {"w": f(t_shape), "m": f(t_shape), "v": np.abs(f(t_shape)),
            "tau": rng.integers(0, 1000, h).astype(np.int32),
            "slots": slots.astype(np.int32), "wv": f(v_shape),
            "mv": f(v_shape), "vv": np.abs(f(v_shape)),
            "tv": rng.integers(1000, 2000, p).astype(np.int32)}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32)


def install_case_slots(kind, h: int, rng) -> np.ndarray:
    if kind == "out_of_range":
        return np.array([h, h + 7, -1, 2 ** 31 - 1] * 4, np.int64)
    n = h if kind == "all" else kind
    slots = np.full(1 << max(n - 1, 0).bit_length(), h, np.int64)
    slots[:n] = rng.permutation(h)[:n]
    return slots


def _install_split(ons):
    """(tables, values) of ``install_rows_tables`` from per-table dicts."""
    return ([tuple(o[k] for k in INSTALL_ARGS[:4]) for o in ons],
            [tuple(o[k] for k in INSTALL_ARGS[5:]) for o in ons])


def install_phase():
    """The install kernel, one launch for fm_w (D = 1) and fm_v (D = 32)
    sharing one slots array, vs its plain version per table on the card
    and the numpy oracle: one transaction of INSTALL_I installs padded to
    INSTALL_P, I = 1, every slot out of range, I = H. Then times of the
    two-table transaction (and of each table alone) beside the bound, the
    plain version's and the ``index_copy_`` calls on the real slots."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 40)
    timing = {}
    for kind in (INSTALL_I, 1, "out_of_range", "all"):
        slots = install_case_slots(kind, INSTALL_H, rng)
        hosts = [install_inputs(INSTALL_H, d, slots, rng)
                 for d in INSTALL_WIDTHS]
        ons = [{k: torch.from_numpy(v).to(dev) for k, v in h.items()}
               for h in hosts]
        kern = [{**o, **{k: o[k].clone() for k in INSTALL_ARGS[:4]}}
                for o in ons]
        plain = [{**o, **{k: o[k].clone() for k in INSTALL_ARGS[:4]}}
                 for o in ons]
        before = ek.install_launches
        tables, values = _install_split(kern)
        ek._launch_install_tables(tables, ons[0]["slots"], values)
        assert ek.install_launches - before == 1
        for pl in plain:
            ek.reference_install(*(pl[k] for k in INSTALL_ARGS))
        torch.cuda.synchronize()
        keep = (slots >= 0) & (slots < INSTALL_H)
        real = slots[keep]
        untouched = np.ones(INSTALL_H, bool)
        untouched[real] = False
        for d, host, kt, pt in zip(INSTALL_WIDTHS, hosts, kern, plain):
            for key, vkey in zip(INSTALL_ARGS[:4], INSTALL_ARGS[5:]):
                got = kt[key].cpu().numpy()
                oracle = host[key].copy()
                oracle[real] = host[vkey][keep]
                assert np.array_equal(_bits(got), _bits(oracle)), (kind, d,
                                                                   key)
                assert np.array_equal(_bits(got),
                                      _bits(pt[key].cpu().numpy()))
                assert np.array_equal(_bits(got[untouched]),
                                      _bits(host[key][untouched]))
        print(f"install check I={real.size} P={slots.size} D="
              f"{'+'.join(map(str, INSTALL_WIDTHS))} in one launch: "
              f"bit-equal to plain and oracle per table, "
              f"{int(untouched.sum())} untouched rows kept, "
              f"{int((~keep).sum())} out-of-range slots dropped")

    slots = install_case_slots(INSTALL_I, INSTALL_H, rng)
    ons = [{k: torch.from_numpy(v).to(dev) for k, v in install_inputs(
        INSTALL_H, d, slots, rng).items()} for d in INSTALL_WIDTHS]
    sl = ons[0]["slots"]
    idx = sl[:INSTALL_I].long()
    for label, part in (("two", ons), (1, ons[:1]), (32, ons[1:])):
        tables, values = _install_split(part)
        real = [(t, x[:INSTALL_I]) for tab, vals in zip(tables, values)
                for t, x in zip(tab, vals)]
        kern = timed(lambda: ek._launch_install_tables(tables, sl, values))
        plain = timed(lambda: [ek.reference_install(*tab, sl, *vals)
                               for tab, vals in zip(tables, values)])
        lib = timed(lambda: [t.index_copy_(0, idx, x) for t, x in real])
        widths = [1 if tab[0].dim() == 1 else tab[0].shape[1]
                  for tab in tables]
        nbytes = 4 * INSTALL_P + sum(2 * INSTALL_I * (3 * 4 * d + 4)
                                     for d in widths)
        bound = bound_of(nbytes, 0)
        timing[label] = (kern, plain, lib, bound)
        print(f"install time D={'+'.join(map(str, widths))} (one launch) "
              f"H={INSTALL_H} I={INSTALL_I} P={INSTALL_P}: "
              f"kernel_ms={kern[0]:.6f} plain_ms={plain[0]:.6f} "
              f"library_ms({len(real)}x index_copy_ on the real slots)="
              f"{lib[0]:.6f} ({kern[2]}) kernel_call_ms={kern[1]:.6f} "
              f"plain_call_ms={plain[1]:.6f} library_call_ms={lib[1]:.6f} "
              f"(cuda_events) bound_ms={bound[0]:.6f} ({bound[1]}: "
              f"{nbytes} B); recorded, not this run: "
              f"{' + '.join(f'{PREV_INSTALL_MS[d]:.6f}' for d in widths)} ms "
              f"in {len(widths)} launch{'es' if len(widths) > 1 else ''} "
              f"(PERF.md)")
    return timing


def random_batches(cfg: Config, n: int, seed: int):
    rng = np.random.default_rng(seed)
    b, f = cfg.batch_size, cfg.field_size
    return [{"feat_ids": rng.integers(0, cfg.feature_size, (b, f)
                                      ).astype(np.int32),
             "feat_vals": rng.random((b, f), dtype=np.float32),
             "label": (rng.random((b, 1)) < 0.3).astype(np.float32)}
            for _ in range(n)]


def _losses(cfg: Config, dev: torch.device, batches):
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    out = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(b))
        out.append(m["loss"])
    return np.array([float(x) for x in out])


def train_parity_phase(cfg: Config, dev: torch.device,
                       steps: int = PARITY_STEPS) -> None:
    """20 steps from one seeded init on the same batches, dropout off: the
    dense update with the kernels and with the plain path, then the sparse
    update on hashed tables with every kernel (plan, take, FM) and with the
    plain legs; per-step losses agree."""
    cfg = cfg.replace(dropout="1.0,1.0,1.0")
    batches = random_batches(cfg, steps, SEED + 7)
    hashed = cfg.replace(**SPARSE_LAYOUTS["sparse_hashed"])
    for name, kern_cfg, plain_cfg, atol in (
            ("dense", cfg, cfg.replace(use_pallas=False), PARITY_LOSS_ATOL),
            ("sparse_hashed", hashed,
             hashed.replace(use_pallas=False, embedding_kernels="xla"),
             SPARSE_PARITY_LOSS_ATOL)):
        counts = (ek.plan_launches, ek.take_fwd_launches,
                  ek.take_bwd_launches, ek.segments_launches)
        kern = _losses(kern_cfg, dev, batches)
        if dev.type == "cuda":
            # One segments launch per step (the dense lookups share theirs).
            assert ek.segments_launches - counts[3] == steps, name
        if name == "sparse_hashed" and dev.type == "cuda":
            # One plan launch for the four tables, one take forward and one
            # take backward per name.
            assert ek.plan_launches - counts[0] == steps
            assert ek.take_fwd_launches - counts[1] == EMB_PARAMS * steps
            assert ek.take_bwd_launches - counts[2] == EMB_PARAMS * steps
        plain = _losses(plain_cfg, dev, batches)
        diff = np.abs(kern - plain)
        assert np.all(np.isfinite(kern)), kern
        assert diff.max() <= atol, (name, kern, plain, diff)
        print(f"train parity {name}: {steps} steps kernel vs plain, max "
              f"|loss diff| {diff.max():.3e} (atol {atol}); loss "
              f"{kern[0]:.5f} -> {kern[-1]:.5f}")


def _seeded_run(cfg: Config, dev: torch.device, batches):
    """Per-step losses and every embedding table after ``train_step`` over
    ``batches`` from the seeded init (dropout drawn from the state's
    seeded generator)."""
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(b))
        losses.append(m["loss"])
    tables = {k: v.detach().clone() for k, v in state.params.items()
              if k.split(".")[0] in ("fm_w", "fm_v")}
    return torch.stack(losses), tables


def determinism_phase(cfg: Config, dev: torch.device,
                      steps: int = DETERMINISM_STEPS,
                      require_equal: bool = True) -> dict:
    """Each layout whose embedding gradient sums cotangents of repeated
    ids (dense, sparse monolithic through the fused leg, dense over hashed
    tables) trained twice for ``steps`` steps from the same seed on the
    same batches (default dropout, drawn from the seeded generator): the
    max |difference| of the losses and of every embedding table between
    the two runs, which must be 0.0."""
    batches = random_batches(cfg, steps, SEED + 9)
    out = {}
    for name, kw in DETERMINISM_LAYOUTS.items():
        la, ta = _seeded_run(cfg.replace(**kw), dev, batches)
        lb, tb = _seeded_run(cfg.replace(**kw), dev, batches)
        dl = float((la - lb).abs().max())
        dt = max(float((ta[k] - tb[k]).abs().max()) for k in ta)
        bits = torch.equal(la, lb) and all(torch.equal(ta[k], tb[k])
                                           for k in ta)
        out[name] = (dl, dt)
        print(f"determinism {name}: {steps} steps twice from seed {SEED}, "
              f"max |loss diff| {dl!r}, max |table diff| {dt!r} over "
              f"{sorted(ta)}; bit-identical={bits}")
        assert np.isfinite(float(la[-1])), (name, la)
        if require_equal:
            assert bits, (name, dl, dt)
    return out


def _fit_run(cfg: Config, dev: torch.device, batches):
    """Per-dispatch losses and the (densified) fm_w/fm_v tables of one
    ``fit`` from the seeded init; and the trainer."""
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    losses = []
    state, _ = trainer.fit(state, batches, hooks=[
        lambda s, m: losses.append(m["loss"])])
    if trainer._tier is not None:
        state = trainer._tier.densified(state)
    tables = {n: state.params[n].detach().float().cpu()
              for n in ("fm_w", "fm_v")}
    return np.array([float(x) for x in losses]), tables, trainer


def tiered_parity_phase(cfg: Config, dev: torch.device,
                        steps: int = PARITY_STEPS, tier: dict = TIERED
                        ) -> None:
    """The hot/cold tier, 20 steps through ``fit`` from one seeded init on
    the same batches, dropout off: against the untiered sparse monolithic
    run, and against the tier's plain install leg (``xla``). Losses and
    densified tables agree; the kernel run installs once per plan."""
    cfg = cfg.replace(dropout="1.0,1.0,1.0")
    batches = random_batches(cfg, steps, SEED + 8)
    tiered = cfg.replace(**tier)
    before = ek.install_launches
    loss_t, tab_t, trainer = _fit_run(tiered, dev, batches)
    plans = trainer._tier.stats["plans"]
    assert plans == steps and trainer._tier.stats["installs"] > 0
    if dev.type == "cuda":
        assert ek.install_launches - before == plans
    print(f"tiered parity: {steps} steps, hit_rate="
          f"{trainer._tier.hit_rate():.4f} evictions="
          f"{trainer._tier.stats['evictions']:.0f} installs="
          f"{trainer._tier.stats['installs']:.0f}")
    untiered = cfg.replace(embedding_update="sparse",
                           steps_per_loop=tier["steps_per_loop"])
    for name, other_cfg in (("untiered", untiered),
                            ("tier_xla", tiered.replace(
                                embedding_kernels="xla"))):
        before = ek.install_launches
        loss_o, tab_o, _ = _fit_run(other_cfg, dev, batches)
        assert ek.install_launches == before, name
        assert np.all(np.isfinite(loss_t)), loss_t
        dl = float(np.abs(loss_t - loss_o).max())
        dt = {n: float((tab_t[n] - tab_o[n]).abs().max()) for n in tab_t}
        assert dl <= TIER_PARITY_LOSS_ATOL, (name, loss_t, loss_o)
        assert max(dt.values()) <= TIER_PARITY_TABLE_ATOL, (name, dt)
        print(f"tiered parity vs {name}: max |loss diff| {dl:.3e} (atol "
              f"{TIER_PARITY_LOSS_ATOL}), max |table diff| fm_w "
              f"{dt['fm_w']:.3e} fm_v {dt['fm_v']:.3e} (atol "
              f"{TIER_PARITY_TABLE_ATOL}); loss {loss_t[0]:.5f} -> "
              f"{loss_t[-1]:.5f}")


class _LossLog(logging.Handler):
    """Collects the fit loop's ``step=... loss=...`` log lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        if record.msg.startswith("step=") and record.args:
            self.losses.append((int(record.args[0]), float(record.args[1])))


def make_train_data(workdir: str, cfg: Config, *, files: int = TRAIN_FILES,
                    per_file: int = TRAIN_PER_FILE,
                    eval_records: int = EVAL_RECORDS) -> dict:
    """Synthetic TFRecords shared by every train phase."""
    data = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    libsvm.generate_synthetic_ctr(
        data, num_files=files, examples_per_file=per_file,
        feature_size=cfg.feature_size, field_size=cfg.field_size, seed=SEED)
    libsvm.generate_synthetic_ctr(
        data, num_files=1, examples_per_file=eval_records,
        feature_size=cfg.feature_size, field_size=cfg.field_size,
        seed=SEED + 1, prefix="va")
    # The infer task reads te* files: the eval records once more.
    shutil.copy(os.path.join(data, "va_0000.tfrecords"),
                os.path.join(data, "te_0000.tfrecords"))
    print(f"train data: {files * per_file} train + {eval_records} eval "
          f"records written in {time.perf_counter() - t0:.1f}s")
    return {"dir": data, "train": files * per_file, "eval": eval_records}


def launch_task(cfg: Config, task: str, dev: torch.device) -> dict:
    """One task through the CLI entry point, ``python -m
    deepfm_tpu_torch.launch``, with ``cfg``'s non-default fields as flags;
    returns its JSON result line."""
    default = Config().to_dict()
    argv = ["--task_type", task]
    for k, v in cfg.to_dict().items():
        if k != "task_type" and v != default[k]:
            argv += [f"--{k}", str(v)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch.main(argv, device=dev)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _counts() -> dict:
    return {"fused_fm": fused_fm.launches,
            "fused_fm_bwd": fused_fm.bwd_launches,
            "plan_build": ek.plan_launches,
            "take_fwd": ek.take_fwd_launches,
            "take_bwd": ek.take_bwd_launches,
            "segments": ek.segments_launches,
            "install": ek.install_launches}


def _zero_counts() -> None:
    fused_fm.launches = fused_fm.bwd_launches = 0
    ek.plan_launches = ek.take_fwd_launches = ek.take_bwd_launches = 0
    ek.segments_launches = ek.install_launches = 0


def train_phase(workdir: str, data: dict, cfg: Config, dev: torch.device,
                name: str = "dense", epochs: int = TRAIN_EPOCHS):
    """The launcher's tasks on ``dev``: train (with an eval after each
    epoch), eval, export; the trained artifact serves. Returns ({kernel:
    launches in the train task}, train result). On a CPU device (a
    rehearsal at a small size) the wrappers launch nothing."""
    run_dir = os.path.join(workdir, name)
    cfg = cfg.replace(data_dir=data["dir"], val_data_dir=data["dir"],
                      model_dir=os.path.join(run_dir, "ckpt"),
                      servable_model_dir=os.path.join(run_dir, "servable"),
                      num_epochs=epochs)
    steps = epochs * (data["train"] // cfg.batch_size)
    eval_batches = -(-data["eval"] // cfg.batch_size)
    hashed = bool(cfg.embedding_bucket_sizes)
    tiered = cfg.embedding_tiering == "hot_cold"

    loss_log = _LossLog()
    loop_log = logging.getLogger("deepfm_tpu_torch.train.loop")
    loop_log.addHandler(loss_log)
    loop_log.setLevel(logging.INFO)
    _zero_counts()
    t0 = time.perf_counter()
    try:
        res = tasks.run(cfg.replace(task_type="train"), device=dev)
    finally:
        loop_log.removeHandler(loss_log)
    wall = time.perf_counter() - t0
    launches = _counts()
    print(f"train {name}: steps={res['steps']:.0f} wall_s={wall:.2f} "
          f"examples_per_sec={res.get('examples_per_sec', 0):.1f} "
          f"step_ms_p50={res.get('step_ms_p50', 0):.3f} (host clock, whole "
          f"input path) final_loss={res['loss']:.5f} auc={res['auc']:.5f} "
          f"eval_loss={res['eval_loss']:.5f} launches={launches}")
    print(f"train {name} logged losses: " + " ".join(
        f"{s}:{l:.4f}" for s, l in loss_log.losses))
    assert res["steps"] == steps, res
    first = np.mean([l for _, l in loss_log.losses[:3]])
    last = np.mean([l for _, l in loss_log.losses[-3:]])
    assert len(loss_log.losses) >= 6 and last < first, loss_log.losses
    assert res["auc"] > 0.5, res
    on = int(dev.type == "cuda")
    emb_steps = steps if hashed else 0
    # The take backward sums the embedding gradients in position order on
    # every layout: once per name (the dense lookups, the hashed views), or
    # once per step for all names (the fused leg of the monolithic table,
    # tiered or not).
    fused_leg = cfg.embedding_update == "sparse" and not hashed
    bwd_per_step = 1 if fused_leg else EMB_PARAMS
    plans = 0
    if tiered:
        # One plan per dispatch, one dispatch per step; every batch misses
        # rows, so every plan installs (once per embedding param).
        plans = int(res["hotcold_plans"])
        assert plans == steps and res["hotcold_installs"] > 0, res
        print(f"train {name} tier: plans={plans} hit_rate="
              f"{res['hotcold_hit_rate']:.4f} evictions="
              f"{res['hotcold_evictions']:.0f} installs="
              f"{res['hotcold_installs']:.0f} overlap_fraction="
              f"{res['hotcold_overlap_fraction']:.4f} apply_s_per_dispatch="
              f"{res['hotcold_apply_s'] / plans:.6f} (host clock)")
    want = {"fused_fm": on * (steps + epochs * eval_batches),
            "fused_fm_bwd": on * steps,
            "plan_build": on * emb_steps,
            "take_fwd": on * EMB_PARAMS * emb_steps,
            "take_bwd": on * bwd_per_step * steps,
            # One segments build per step on every layout: the dense
            # lookups' (both names, every hashed table), the hashed plan's
            # or the fused leg's.
            "segments": on * steps,
            "install": on * plans}
    assert launches == want, (name, launches, want)

    _zero_counts()
    ev = launch_task(cfg, "eval", dev)
    assert ev["task"] == "eval" and abs(ev["auc"] - res["auc"]) < 1e-3, (
        ev, res)
    assert _counts() == {**{k: 0 for k in want},
                         "fused_fm": on * eval_batches}, _counts()
    inf = launch_task(cfg, "infer", dev)
    assert inf["num_predictions"] == data["eval"], inf
    preds = np.loadtxt(os.path.join(data["dir"], "pred.txt"))
    assert preds.shape == (data["eval"],) and np.all((preds > 0)
                                                      & (preds < 1))
    out = tasks.run(cfg.replace(task_type="export",
                                servable_model_dir=os.path.join(
                                    run_dir, "exported")), device=dev)
    assert out["step"] == steps
    artifact = os.path.join(run_dir, "exported", str(steps))
    serve = export_lib.load_serving(artifact, device=dev,
                                    buckets=export_lib.serving_buckets(256))
    rng = np.random.default_rng(SEED + 3)
    ids = rng.integers(0, cfg.feature_size, (100, cfg.field_size)
                       ).astype(np.int32)
    vals = rng.random((100, cfg.field_size), dtype=np.float32)
    probs = serve(ids, vals)
    plain = export_lib.load_model(artifact, device=dev, use_pallas=False)[0]
    with torch.inference_mode():
        ref = torch.sigmoid(plain(torch.from_numpy(ids).to(dev),
                                  torch.from_numpy(vals).to(dev))).cpu()
    assert probs.shape == (100,) and np.all(np.isfinite(probs))
    err = float(np.abs(probs - ref.numpy()).max())
    assert err <= SERVE_ATOL, err
    print(f"eval task {name} (launcher): auc={ev['auc']:.5f} "
          f"loss={ev['loss']:.5f}; infer task (launcher): "
          f"{inf['num_predictions']:.0f} predictions; export step "
          f"{out['step']:.0f} served 100 rows, max_abs_err_vs_plain="
          f"{err:.3e}")
    return launches, res


def device_kernel_names(fn, iters: int = 3) -> set:
    """Names of the device events of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _step_timing(cfg: Config, name: str, batch, top: bool,
                 no_sort: bool = False) -> None:
    dev = torch.device("cuda")
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    dev_batch = trainer.put_batch(batch)
    step = lambda: trainer.train_step(state, dev_batch)  # noqa: E731
    if no_sort:
        # The position segments come from the segments kernel: no radix
        # sort (or any other sort) runs in the step.
        names = device_kernel_names(step)
        sorts = sorted(n for n in names if "sort" in n.lower())
        assert names and not sorts, (name, sorts)
        print(f"train step {name}: no sort among the step's {len(names)} "
              f"device kernel names")
    call = cuda_ms(step, iters=50, warmup=5)
    busy, events = device_profile(step, iters=10)
    busy_txt = "not measured" if busy is None else f"{busy:.4f}"
    idle = ("not measured" if busy is None
            else f"{max(0.0, 1 - busy / call):.3f}")
    print(f"train step B={cfg.batch_size} {name}: step_ms={call:.4f} "
          f"examples_per_sec={cfg.batch_size / call * 1e3:.0f} "
          f"device_busy_ms={busy_txt} device_events={events:g} "
          f"idle_share={idle}")
    if top and busy is not None:
        top_kernels(step, label=name)


def train_step_timing(cfg: Config) -> None:
    """One training step at B=1024, reference width (CUDA events over
    back-to-back steps; device busy time per step from torch.profiler, and
    the idle share): the dense kernel path vs plain path in turns, then the
    dense, sparse monolithic and sparse hashed updates in turns."""
    batch = random_batches(cfg, 1, SEED + 11)[0]
    for i, (name, use_pallas) in enumerate((
            ("kernel_path", True), ("plain_path", False),
            ("kernel_path", True), ("plain_path", False))):
        _step_timing(cfg.replace(use_pallas=use_pallas), name, batch,
                     top=i == 0)
    layouts = {"dense": {}, **SPARSE_LAYOUTS}
    for turn in range(2):
        for name, kw in layouts.items():
            _step_timing(cfg.replace(**kw), name, batch,
                         top=turn == 0 and name != "dense",
                         no_sort=turn == 0)
        tiered_dispatch_timing(cfg.replace(**TIERED), top=turn == 0)


def tiered_dispatch_timing(cfg: Config, top: bool, n: int = 20) -> None:
    """One dispatch of the tier at B=1024 through ``fit`` (plan on the
    staging thread, apply, step): host clock over ``n`` distinct batches
    after a warm-up that fills the cache; then ``n`` more with span tracing
    on, for the time per dispatch of each span (``hotcold.plan`` runs on
    the staging thread) and the tracing's own cost; device busy time and
    events per dispatch from torch.profiler over single-batch fits."""
    dev = torch.device("cuda")
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    batches = random_batches(cfg, 5 + 2 * n + 2 * 11, SEED + 12)
    state, _ = trainer.fit(state, batches[:5])
    stats = trainer._tier.stats
    apply0 = stats["apply_s"]
    t0 = time.perf_counter()
    state, _ = trainer.fit(state, batches[5:5 + n])  # ends in a sync
    per = (time.perf_counter() - t0) / n * 1e3
    apply_ms = (stats["apply_s"] - apply0) / n * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace_lib.configure("full", export_env=False)
        try:
            t0 = time.perf_counter()
            state, _ = trainer.fit(state, batches[5 + n:5 + 2 * n])
            traced = (time.perf_counter() - t0) / n * 1e3
            with open(trace_lib.export(os.path.join(tmp, "t.json"))) as f:
                events = json.load(f)["traceEvents"]
        finally:
            trace_lib.reset()
    spans = {}
    for ev in events:
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    print(f"train dispatch B={cfg.batch_size} sparse_tiered traced: "
          f"dispatch_ms={traced:.4f} (tracing on; off: {per:.4f}) per "
          "dispatch: " + " ".join(f"{k}={v / n:.4f}ms"
                                  for k, v in sorted(spans.items())))
    rest = iter(batches[5 + 2 * n:])
    one = lambda: trainer.fit(state, [next(rest)])  # noqa: E731
    busy, events = device_profile(one, iters=10)
    busy_txt = "not measured" if busy is None else f"{busy:.4f}"
    idle = ("not measured" if busy is None
            else f"{max(0.0, 1 - busy / per):.3f}")
    print(f"train dispatch B={cfg.batch_size} sparse_tiered: dispatch_ms="
          f"{per:.4f} (host clock, {n} batches through fit: plan + apply + "
          f"step) apply_ms={apply_ms:.4f} examples_per_sec="
          f"{cfg.batch_size / per * 1e3:.0f} device_busy_ms={busy_txt} "
          f"device_events={events:g} idle_share={idle}")
    if top and busy is not None:
        top_kernels(one, label="sparse_tiered")


def top_kernels(fn, iters: int = 10, top: int = 8,
                label: str = "kernel_path") -> None:
    """Device time per step by kernel name, largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    short = lambda n: n.replace("void ", "").replace(  # noqa: E731
        "at::native::", "").replace("(anonymous namespace)::", "")[:90]
    print(f"train step {label} top kernels (us per step): " + "; ".join(
        f"{short(name)}={us / iters:.1f}" for name, us in ranked))


def serve_phase(workdir: str, cfg: Config, dev: torch.device,
                n_requests: int = N_REQUESTS):
    """Publish a seeded DeepFM, serve it through ``serve_latest`` and check
    every response. Returns (fused_fm launches over the requests, artifact
    path). On a CPU device (a rehearsal at a small size) the kernel's
    wrapper takes its plain version and launches nothing."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = get_model(cfg, device=dev, generator=gen)
    with torch.no_grad():
        model.fm_w.mul_(EMB_SCALE)
        model.fm_v.mul_(EMB_SCALE)
    publish = os.path.join(workdir, "publish")
    artifact = export_lib.export_serving(model, cfg,
                                         os.path.join(publish, "v1"), step=1)
    export_lib.write_latest(publish, "v1")
    print(f"serve config: V={cfg.feature_size} (padded {model.padded_vocab}) "
          f"F={cfg.field_size} K={cfg.embedding_size} tower={cfg.deep_layers} "
          f"compute={cfg.compute_dtype} batch_norm={cfg.batch_norm} "
          f"max_batch={cfg.serve_max_batch} delay_ms={cfg.serve_max_delay_ms} "
          f"inflight={cfg.serve_inflight}")
    del model

    rng = np.random.default_rng(SEED)
    sizes = [min(int(n), cfg.serve_max_batch)
             for n in rng.choice(REQUEST_SIZES, size=n_requests)]
    requests = [(rng.integers(0, cfg.feature_size, (n, cfg.field_size)
                              ).astype(np.int32),
                 rng.random((n, cfg.field_size), dtype=np.float32))
                for n in sizes]

    buckets = export_lib.serving_buckets(cfg.serve_max_batch)
    engine = ServingEngine.serve_latest(
        publish, max_batch=cfg.serve_max_batch,
        max_delay_ms=cfg.serve_max_delay_ms, inflight=cfg.serve_inflight,
        buckets=buckets, watcher_kw={"loader": lambda path: (
            export_lib.load_serving(path, buckets=buckets, device=dev))})
    results = [None] * n_requests
    errors = []
    try:
        # The watcher's bucket warm-up launched the kernel already; count
        # only what the requests drive.
        fused_fm.launches = 0

        def client(c):
            try:
                for j in range(c, n_requests, N_CLIENTS):
                    fut = engine.submit(*requests[j])
                    results[j] = (fut.result(timeout=300), fut.latency_ms)
            except BaseException as e:  # re-raised below on the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = fused_fm.launches
        flushes = engine.stats.flushes
        summary = engine.stats.summary()
    finally:
        engine.close(timeout=60)
    if errors:
        raise errors[0]

    ref_model = export_lib.load_model(artifact, device=dev,
                                      use_pallas=False)[0]
    max_err = 0.0
    for (ids, vals), (probs, _) in zip(requests, results):
        assert probs.shape == (ids.shape[0],), probs.shape
        assert np.all(np.isfinite(probs)), "non-finite probability"
        assert np.all((probs >= 0) & (probs <= 1)), "probability outside [0,1]"
        with torch.inference_mode():
            ref = torch.sigmoid(ref_model(torch.from_numpy(ids).to(dev),
                                          torch.from_numpy(vals).to(dev)))
        max_err = max(max_err, float(np.abs(probs - ref.cpu().numpy()).max()))
    assert max_err <= SERVE_ATOL, (
        f"served probabilities differ from the plain forward by {max_err}")
    expected = flushes if dev.type == "cuda" else 0
    assert launches == expected and (launches > 0 or dev.type != "cuda"), (
        f"fused_fm launched {launches} times over {flushes} flushes")

    lat = np.array([r[1] for r in results])
    spread = np.concatenate([r[0] for r in results])
    rows = int(sum(sizes))
    print(f"serve: requests={n_requests} rows={rows} clients={N_CLIENTS} "
          f"wall_s={wall:.3f} qps={n_requests / wall:.1f} "
          f"rows_per_s={rows / wall:.1f} p50_ms={np.percentile(lat, 50):.3f} "
          f"p99_ms={np.percentile(lat, 99):.3f} flushes={flushes} "
          f"fused_fm_launches={launches} "
          f"occupancy_pct={summary['batch_occupancy_pct']} "
          f"max_abs_err_vs_plain={max_err:.3e} (atol {SERVE_ATOL}) "
          f"prob_range=[{spread.min():.4f}, {spread.max():.4f}]")
    return launches, artifact


def forward_timing(artifact: str, cfg: Config) -> None:
    """The model forward alone at one full flush: kernel path vs plain."""
    dev = torch.device("cuda")
    model = export_lib.load_model(artifact, device=dev)[0]
    plain = export_lib.load_model(artifact, device=dev, use_pallas=False)[0]
    rng = np.random.default_rng(SEED + 1)
    b = cfg.serve_max_batch
    ids = torch.from_numpy(rng.integers(0, cfg.feature_size,
                                        (b, cfg.field_size)).astype(np.int32)
                           ).to(dev)
    vals = torch.from_numpy(rng.random((b, cfg.field_size),
                                       dtype=np.float32)).to(dev)
    with torch.inference_mode():
        for name, m in (("kernel_path", model), ("plain_path", plain)):
            call = cuda_ms(lambda: m(ids, vals), iters=100)
            busy, events = device_profile(lambda: m(ids, vals))
            busy_txt = "not measured" if busy is None else f"{busy:.4f}"
            idle = ("not measured" if busy is None
                    else f"{max(0.0, 1 - busy / call):.3f}")
            print(f"forward B={b} {name}: call_ms={call:.4f} "
                  f"device_busy_ms={busy_txt} device_events={events:g} "
                  f"idle_share={idle}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    build_s = _native.build()
    print(f"kernel build: {build_s:.2f}s (nvcc {' '.join(_native.NVCC_FLAGS)})")

    fm_err, fm_t = kernel_phase()
    kern_ms, plain_ms, bound_ms, bound_by, ms_source = fm_t[TIMED_SHAPE]
    bwd_err, (bwd_ms, bwd_plain_ms, bwd_bound_ms, bwd_bound_by,
              bwd_source) = kernel_bwd_phase()
    plan_t = plan_phase()
    seg_kernel_t = segments_kernel_phase()
    take_err, take_t, seg_t = take_phase()
    segment_sum_phase()
    install_t = install_phase()

    cfg = Config()
    dev = torch.device("cuda")
    determinism_phase(cfg, dev)
    train_parity_phase(cfg, dev)
    tiered_parity_phase(cfg, dev)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
    try:
        data = make_train_data(workdir, cfg)
        paths = {"train": train_phase(workdir, data, cfg, dev)[0]}
        for name, kw in {**SPARSE_LAYOUTS, "sparse_tiered": TIERED}.items():
            paths["train_" + name] = train_phase(
                workdir, data, cfg.replace(**kw), dev, name=name)[0]
        train_step_timing(cfg)
        serve_launches, artifact = serve_phase(workdir, cfg, dev)
        forward_timing(artifact, cfg)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    def by_path(kernel):
        return {p: c[kernel] for p, c in paths.items()}

    hashed = paths["train_sparse_hashed"]
    # The main path's shapes: the hashed step's four-table plan launch, its
    # four-table take forward and backward, at D = 32.
    (pk, pp, pl, pb, pby, psrc) = plan_t[HASHED_TABLES]
    plan = {
        "ms": pk, "plain_ms": pp, "library_ms": pl,
        "library_call": "torch.unique over the four tables' ids at once",
        "bound_ms": pb, "bound_by": pby, "ms_source": psrc,
        "floor_ms": plan_t["floor"],
        "by_tables": {str(t): {"ms": v[0], "plain_ms": v[1],
                               "library_ms": v[2], "bound_ms": v[3]}
                      for t, v in plan_t.items() if t != "floor"}}
    take = {}
    for name in ("take_fwd", "take_bwd"):
        (k, _, src), (p, _, _), (lb, _, _), (bd, by) = take_t[
            (name, HASHED_TABLES, 32)]
        take[name] = {
            "ms": k, "plain_ms": p, "library_ms": lb, "bound_ms": bd,
            "bound_by": by, "ms_source": src,
            "by_shape": {f"T{t}_D{d}": {
                "ms": v[0][0], "plain_ms": v[1][0], "library_ms": v[2][0],
                "bound_ms": v[3][0]}
                for (n, t, d), v in take_t.items() if n == name}}
    take["take_fwd"]["library_call"] = (
        "embedding_bag(mode='sum', per_sample_weights=masks) over the "
        "tables concatenated")
    take["take_bwd"]["library_call"] = (
        "one index_add_ over the tables' outputs end to end")
    take["take_bwd"]["segments_build"] = {
        k: {"device_ms": v[0], "device_events": v[1], "call_ms": v[2]}
        for k, v in seg_t.items()}
    # The segments kernel at the hashed step's shape (the main path's
    # launch), and at the dense and fused-leg shapes.
    (sk, _, ssrc), (sp, _, _), (sl, _, _), (sb, sby, _), _ = seg_kernel_t[
        "hashed"]
    segments = {
        "ms": sk, "plain_ms": sp, "library_ms": sl,
        "library_call": "torch.sort(stable=True) + searchsorted over "
                        "precomputed composite keys",
        "bound_ms": sb, "bound_by": sby, "ms_source": ssrc,
        "by_shape": {k: {"ms": v[0][0], "plain_ms": v[1][0],
                         "library_ms": v[2][0], "bound_ms": v[3][0],
                         "device_events": v[4]}
                     for k, v in seg_kernel_t.items()}}
    (ik, _, isrc), (ip, _, _), (il, _, _), (ib, iby) = install_t["two"]
    install = {
        "ms": ik, "plain_ms": ip, "library_ms": il,
        "library_call": "8x index_copy_ on the real slots",
        "bound_ms": ib, "bound_by": iby, "ms_source": isrc,
        "by_width": {str(d): {"ms": v[0][0], "plain_ms": v[1][0],
                              "library_ms": v[2][0], "bound_ms": v[3][0]}
                     for d, v in install_t.items()}}
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "fused_fm", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/fused_fm.cu",
        "replaces": "deepfm_tpu/ops/pallas_fm.py:79",
        "launches": paths["train"]["fused_fm"],
        "launches_by_path": {**by_path("fused_fm"), "serve": serve_launches},
        "max_abs_err": fm_err,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "ms_source": ms_source,
        "by_batch": {str(b): {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2]}
                     for (b, _, _), v in fm_t.items()}}, {
        "name": "fused_fm_bwd", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/fused_fm.cu",
        "replaces": "deepfm_tpu/ops/pallas_fm.py:92",
        "launches": paths["train"]["fused_fm_bwd"],
        "launches_by_path": by_path("fused_fm_bwd"),
        "max_abs_err": bwd_err,
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": None,
        "ms_source": bwd_source}, {
        "name": "plan_build", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:121",
        "launches": hashed["plan_build"],
        "launches_by_path": by_path("plan_build"),
        "max_abs_err": 0.0, **plan}, {
        "name": "take_fwd", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:216",
        "launches": hashed["take_fwd"],
        "launches_by_path": by_path("take_fwd"),
        "max_abs_err": 0.0, **take["take_fwd"]}, {
        "name": "take_bwd", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:226",
        "launches": hashed["take_bwd"],
        "launches_by_path": by_path("take_bwd"),
        "max_abs_err": take_err, **take["take_bwd"]}, {
        "name": "segments", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:226",
        "launches": hashed["segments"],
        "launches_by_path": by_path("segments"),
        "max_abs_err": 0.0, **segments}, {
        "name": "install", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:302",
        "launches": paths["train_sparse_tiered"]["install"],
        "launches_by_path": by_path("install"),
        "max_abs_err": 0.0, **install}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
