#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deepfm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. The card's name and power limit (``nvidia-smi``); build every CUDA
   kernel of the port from ``deepfm_tpu_torch/csrc`` with nvcc, in parallel.
2. Kernel phase: the ``fused_fm`` forward kernel against ``reference_fm``
   (plain PyTorch) on the card, float32 and bfloat16 inputs, at the serving
   shapes and a few others; then the kernel's time beside its bound and the
   plain version's time.
3. Backward kernel phase: the ``fused_fm`` backward kernel against
   ``reference_fm_bwd``, float32 and bfloat16, at the training shapes and a
   few others, with the gradients' dtypes, and ``torch.autograd.grad``
   through ``fused_fm`` against the same through ``reference_fm``; then its
   time beside its bound and the plain version's at the training shape.
4. Plan kernel phase: the plan build kernel against its plain version
   ``make_plan_counting`` on the card and the numpy oracle, bit-equal uids,
   inv and touched (rank under touched), at one hashed table's training
   view (N = 1024*39 ids, 262,144 rows, 3/4 of the positions at the fill
   id), the monolithic table, N = 1, all ids equal, all fill, N > rows and
   2,000,000 rows; then its time beside its bound, the plain version's and
   ``torch.unique``'s.
5. Take kernel phase: the gather forward bit-equal to ``rows[inv]``, the
   segment-sum backward bit-equal to the CPU position-order oracle and to
   its own second launch, and within a tolerance of the plain backward on
   the card, at D = 1 and 32, U = N = 39,936; then times beside the bounds,
   the plain versions and ``index_select`` / ``index_add_``.
6. Train parity: DeepFM at the reference width, one seeded init, 20 steps
   on the same batches (dropout keep 1.0) with the kernels
   (``use_pallas=True``) and with the plain path; the losses must agree.
   Then the same for the sparse update with hashed tables: kernels
   (``embedding_kernels=auto``) against the plain legs (``xla``, no fused
   FM).
7. Train phases: synthetic TFRecords at the reference width written once
   with the port's ``generate_synthetic_ctr``, then ``tasks.run`` train
   (the ``Config()`` defaults: dropout keep 0.5, Adam, batch 1024; two
   epochs, an eval after each), eval and export, all on the card, three
   times: the dense update, the sparse update on the monolithic table and
   the sparse update on 4 hashed tables of 262,144 rows; eval and infer go
   through the CLI entry point (``deepfm_tpu_torch.launch``). The logged
   loss must fall, eval AUC exceed 0.5, the FM backward kernel launch once per
   train step and the forward once per train step and eval batch, the plan
   kernel 4 times and each take kernel 8 times per hashed step and never
   on the other two; each trained artifact then serves. Then the step time
   at B=1024 of the dense kernel and plain paths, and of the three layouts,
   with one step's device busy time and idle share.
8. Serve phase: DeepFM at the reference width (``Config()`` defaults:
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
and serving; the plan and take kernels over the hashed sparse train task.

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
FM_CASES = [(b, 39, 32) for b in (1, 7, 256, 1024)] + [(256, 13, 8),
                                                       (256, 39, 48)]
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
# only in float32 sum order (the FM reductions, and the atomics of the
# embedding backward) until a bfloat16 tower rounds an input one ulp
# apart; between the JAX package and the port on the CPU the same bf16
# trajectory agreed to 2e-5 per step (tests/test_torch_train.py).
PARITY_STEPS = 20
PARITY_LOSS_ATOL = 1e-3

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
]
# The take backward against the plain backward on the card: a float32 sum
# of the same terms that autograd's accumulate may take in another order;
# at most a few dozen terms per slot here, so within 1e-5 of the value.
TAKE_BWD_TOL = dict(rtol=1e-5, atol=1e-5)
# Sparse train parity (hashed, kernels vs plain legs): the take backward
# and plan are bit-equal across legs; the fused FM's float32 sum order and
# the bf16 tower differ as in the dense parity.
SPARSE_PARITY_LOSS_ATOL = 1e-3

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


def fm_inputs(b, f, k, dtype, seed):
    g = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        g.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    return mk(b, f), mk(b, f), mk(b, f, k)


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
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, f, k) in enumerate(FM_CASES):
            w, vals, xv = fm_inputs(b, f, k, dtype, SEED + i)
            got = fused_fm(w, vals, xv)
            want = reference_fm(w, vals, xv)
            torch.cuda.synchronize()
            assert got.shape == (b,) and got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=FM_RTOL, atol=FM_ATOL)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            print(f"fused_fm check dtype={str(dtype)[6:]} B={b} F={f} K={k} "
                  f"max_abs_err={err:.3e}")

    # Two times per call: the device time of its kernels (torch.profiler),
    # which is what the bound compares with, and the per-call time on the
    # device timeline of back-to-back calls (CUDA events), which includes
    # the host's launch cost between kernels.
    timing = {}
    for b in (1, 7, 256, 1024):
        f, k = TIMED_SHAPE[1:]
        w, vals, xv = fm_inputs(b, f, k, torch.float32, SEED)
        kern_call = cuda_ms(lambda: fused_fm(w, vals, xv))
        plain_call = cuda_ms(lambda: reference_fm(w, vals, xv))
        kern = device_profile(lambda: fused_fm(w, vals, xv))[0]
        plain = device_profile(lambda: reference_fm(w, vals, xv))[0]
        source = "profiler"
        if kern is None or plain is None:
            kern, plain, source = kern_call, plain_call, "cuda_events"
        bound, bound_by = fm_bound(b, f, k, 4)
        timing[(b, f, k)] = (kern, plain, bound, bound_by, source)
        print(f"fused_fm time f32 B={b} F={f} K={k}: kernel_ms={kern:.6f} "
              f"plain_ms={plain:.6f} ({source}) kernel_call_ms={kern_call:.6f} "
              f"plain_call_ms={plain_call:.6f} (cuda_events) "
              f"bound_ms={bound:.6f} ({bound_by}: HBM "
              f"{HBM_BYTES_PER_S / 1e12} TB/s, f32 "
              f"{F32_FLOPS_PER_S / 1e12} TFLOP/s)")
    print("fused_fm library_ms: none (no single PyTorch call computes the "
          "fused first+second order FM)")
    return max_err, timing[TIMED_SHAPE]


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


def plan_phase():
    """Plan kernel vs plain (and the numpy oracle) at every listed shape,
    then timings at one hashed table's training view."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 20)
    for label, n, rows, kind in PLAN_CASES:
        ids = plan_case_ids(n, rows, kind, rng)
        t = torch.from_numpy(ids).to(dev)
        got = ek.plan_build_kernel(t, rows)
        want = emb_ops.make_plan_counting(t, rows)
        torch.cuda.synchronize()
        for f in ("uids", "inv", "touched"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (label, f)
        assert torch.equal(got.rank[got.touched], want.rank[want.touched])
        uids, inv, touched, rank = ek.reference_plan_numpy(ids, rows)
        assert np.array_equal(got.uids.cpu().numpy(), uids), label
        assert np.array_equal(got.inv.cpu().numpy(), inv), label
        assert np.array_equal(got.touched.cpu().numpy(), touched), label
        print(f"plan check {label}: N={n} rows={rows} uniques="
              f"{int((got.uids < rows).sum())} bit-equal to plain and oracle")

    ids = plan_case_ids(PLAN_N, HASHED_ROWS, 0.75, rng)
    t = torch.from_numpy(ids).to(dev)
    kern, kern_call, source = timed(lambda: ek.plan_build_kernel(
        t, HASHED_ROWS))
    plain, plain_call, _ = timed(lambda: emb_ops.make_plan_counting(
        t, HASHED_ROWS))
    lib, lib_call, _ = timed(lambda: torch.unique(
        t, sorted=True, return_inverse=True))
    n, rows = PLAN_N, HASHED_ROWS
    nbytes = 3 * 4 * n + rows + 4 * (rows + 1)
    bound, bound_by = bound_of(nbytes, 4 * n + 4 * (rows + 1))
    print(f"plan time N={n} rows={rows} fill=0.75: kernel_ms={kern:.6f} "
          f"plain_ms={plain:.6f} library_ms(torch.unique)={lib:.6f} "
          f"({source}) kernel_call_ms={kern_call:.6f} plain_call_ms="
          f"{plain_call:.6f} library_call_ms={lib_call:.6f} (cuda_events) "
          f"bound_ms={bound:.6f} ({bound_by}: {nbytes} B)")
    return kern, plain, lib, bound, bound_by, source


def take_phase():
    """Take forward and backward kernels vs plain and the CPU oracle, at
    D = 1 and 32, U = N = 39,936: random slots (every run a few positions
    long) and one hashed table's plan (3/4 of the positions masked, as the
    train step feeds it). Then times at the hashed plan's shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    rng = np.random.default_rng(SEED + 31)
    n = PLAN_N
    ids = plan_case_ids(n, HASHED_ROWS, 0.75, rng)
    plan = ek.plan_build_kernel(torch.from_numpy(ids).to(dev), HASHED_ROWS)
    mask = (plan.uids.new_tensor(ids) < HASHED_ROWS).float()
    rand_inv = torch.from_numpy(rng.integers(0, n // 4, n).astype(np.int32)
                                ).to(dev)
    max_err, timing = 0.0, {}
    for d in (1, 32):
        rows = torch.randn(n, d, device=dev, generator=gen)
        g = torch.randn(n, d, device=dev, generator=gen)
        for label, inv, gg, keep in (
                ("random", rand_inv, g, None),
                ("hashed_plan", plan.inv, g * mask[:, None], mask > 0)):
            out = ek._launch_take_fwd(rows, inv)
            assert torch.equal(out, ek.reference_take(rows, inv)), (label, d)
            seg = ek.position_segments(inv, n, keep=keep)
            a = ek._launch_take_bwd(gg, seg, n)
            b = ek._launch_take_bwd(gg, seg, n)
            plain = ek.reference_take_bwd(gg, inv, n)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (label, d)
            oracle = np.zeros((n, d), np.float32)
            np.add.at(oracle, inv.cpu().numpy(), gg.cpu().numpy())
            assert np.array_equal(a.cpu().numpy(), oracle), (label, d)
            torch.testing.assert_close(a, plain, **TAKE_BWD_TOL)
            err = float((a - plain).abs().max())
            max_err = max(max_err, err)
            print(f"take check {label} D={d}: forward bit-equal, backward "
                  f"bit-equal to the CPU oracle and to its second launch, "
                  f"max |kernel - plain on card| {err:.3e}")
        # autograd through take_rows (the path lookup_rows takes)
        leaf = rows.clone().requires_grad_()
        seg = ek.position_segments(plan.inv, n, keep=mask > 0)
        view = ek.take_rows(leaf, plan.inv, segments=seg) * mask[:, None]
        d_rows, = torch.autograd.grad(view, leaf, g)
        assert torch.equal(d_rows, ek._launch_take_bwd(g * mask[:, None],
                                                       seg, n))

        inv, gg = plan.inv, g * mask[:, None]
        seg = ek.position_segments(inv, n, keep=mask > 0)
        inv64 = inv.long()
        fwd = timed(lambda: ek._launch_take_fwd(rows, inv))
        fwd_plain = timed(lambda: ek.reference_take(rows, inv))
        fwd_lib = timed(lambda: rows.index_select(0, inv64))
        bwd = timed(lambda: ek._launch_take_bwd(gg, seg, n))
        bwd_plain = timed(lambda: ek.reference_take_bwd(gg, inv, n))
        bwd_lib = timed(lambda: torch.zeros(n, d, device=dev).index_add_(
            0, inv64, gg))
        # What this run's data needs: the forward reads inv, each referenced
        # row once and writes N rows; the backward reads the kept positions
        # and their cotangent rows and writes U rows.
        ref_rows = int((plan.uids < HASHED_ROWS).sum()) + 1
        kept = int((mask > 0).sum())
        fb = bound_of(4 * n + 4 * d * (n + ref_rows), 0)
        bb = bound_of(4 * kept + 4 * d * (kept + n), kept * d)
        timing[d] = (fwd, fwd_plain, fwd_lib, fb, bwd, bwd_plain, bwd_lib, bb)
        for name, (k, kc, src), (p, pc, _), (lb, lc, _), (bd, by) in (
                ("take_fwd", fwd, fwd_plain, fwd_lib, fb),
                ("take_bwd", bwd, bwd_plain, bwd_lib, bb)):
            lib_name = "index_select" if name == "take_fwd" else "index_add_"
            print(f"{name} time D={d} N=U={n} (hashed plan, {kept} kept "
                  f"positions, {ref_rows} referenced rows): kernel_ms={k:.6f} "
                  f"plain_ms={p:.6f} library_ms({lib_name})={lb:.6f} ({src}) "
                  f"kernel_call_ms={kc:.6f} plain_call_ms={pc:.6f} "
                  f"library_call_ms={lc:.6f} (cuda_events) bound_ms={bd:.6f} "
                  f"({by})")
    return max_err, timing


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
        counts = (ek.plan_launches, ek.take_fwd_launches)
        kern = _losses(kern_cfg, dev, batches)
        if name == "sparse_hashed" and dev.type == "cuda":
            assert ek.plan_launches - counts[0] == HASHED_TABLES * steps
            assert ek.take_fwd_launches - counts[1] == (
                HASHED_TABLES * EMB_PARAMS * steps)
        plain = _losses(plain_cfg, dev, batches)
        diff = np.abs(kern - plain)
        assert np.all(np.isfinite(kern)), kern
        assert diff.max() <= atol, (name, kern, plain, diff)
        print(f"train parity {name}: {steps} steps kernel vs plain, max "
              f"|loss diff| {diff.max():.3e} (atol {atol}); loss "
              f"{kern[0]:.5f} -> {kern[-1]:.5f}")


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
            "take_bwd": ek.take_bwd_launches}


def _zero_counts() -> None:
    fused_fm.launches = fused_fm.bwd_launches = 0
    ek.plan_launches = ek.take_fwd_launches = ek.take_bwd_launches = 0


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
    want = {"fused_fm": on * (steps + epochs * eval_batches),
            "fused_fm_bwd": on * steps,
            "plan_build": on * HASHED_TABLES * emb_steps,
            "take_fwd": on * HASHED_TABLES * EMB_PARAMS * emb_steps,
            "take_bwd": on * HASHED_TABLES * EMB_PARAMS * emb_steps}
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


def _step_timing(cfg: Config, name: str, batch, top: bool) -> None:
    dev = torch.device("cuda")
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    dev_batch = trainer.put_batch(batch)
    step = lambda: trainer.train_step(state, dev_batch)  # noqa: E731
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
                         top=turn == 0 and name != "dense")


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

    fm_err, (kern_ms, plain_ms, bound_ms, bound_by, ms_source) = \
        kernel_phase()
    bwd_err, (bwd_ms, bwd_plain_ms, bwd_bound_ms, bwd_bound_by,
              bwd_source) = kernel_bwd_phase()
    plan_ms, plan_plain, plan_lib, plan_bound, plan_by, plan_src = \
        plan_phase()
    take_err, take_t = take_phase()

    cfg = Config()
    dev = torch.device("cuda")
    train_parity_phase(cfg, dev)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
    try:
        data = make_train_data(workdir, cfg)
        paths = {"train": train_phase(workdir, data, cfg, dev)[0]}
        for name, kw in SPARSE_LAYOUTS.items():
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
    take = {}
    for i, name in enumerate(("take_fwd", "take_bwd")):
        per_d = {d: take_t[d][4 * i:4 * i + 4] for d in take_t}
        (k, _, src), (p, _, _), (lb, _, _), (bd, by) = per_d[32]
        take[name] = {
            "ms": k, "plain_ms": p, "library_ms": lb, "bound_ms": bd,
            "bound_by": by, "ms_source": src,
            "by_width": {str(d): {"ms": v[0][0], "plain_ms": v[1][0],
                                  "library_ms": v[2][0],
                                  "bound_ms": v[3][0]}
                         for d, v in per_d.items()}}
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
        "ms_source": ms_source}, {
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
        "max_abs_err": 0.0,
        "ms": plan_ms, "plain_ms": plan_plain, "bound_ms": plan_bound,
        "bound_by": plan_by, "library_ms": plan_lib,
        "ms_source": plan_src}, {
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
        "max_abs_err": take_err, **take["take_bwd"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
