#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deepfm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. The card's name and power limit (``nvidia-smi``); build every CUDA
   kernel of the port from ``deepfm_tpu_torch/csrc`` with nvcc, in parallel.
2. Kernel phase: ``fused_fm`` (hand-written CUDA) against ``reference_fm``
   (plain PyTorch) on the card, float32 and bfloat16 inputs, at the serving
   shapes and a few others; then the kernel's time beside its bound and the
   plain version's time.
3. Serve phase: DeepFM at the reference width (``Config()`` defaults:
   V=117,581, F=39, K=32, tower 128-64-32, bfloat16 tower) with random
   weights from a seed, exported, published behind ``LATEST`` and served by
   ``ServingEngine.serve_latest`` to several client threads. Every response
   is checked against the plain forward (``use_pallas=False``) on the same
   weights on the card, and the kernel's launch count over the requests
   must equal the number of flushes.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero and prints no result.

Numerics: float32 matmuls run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``) and bfloat16 matmuls
accumulate without reduced-precision reductions
(``allow_bf16_reduced_precision_reduction = False``); the serve tolerance
below assumes both.
"""

from __future__ import annotations

import json
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

from deepfm_tpu_torch import _native  # noqa: E402
from deepfm_tpu_torch.config import Config  # noqa: E402
from deepfm_tpu_torch.models import get_model  # noqa: E402
from deepfm_tpu_torch.ops.fused_fm import fused_fm, reference_fm  # noqa: E402
from deepfm_tpu_torch.serve import ServingEngine  # noqa: E402
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

    cfg = Config()
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
    try:
        fm_launches, artifact = serve_phase(workdir, cfg,
                                            torch.device("cuda"))
        forward_timing(artifact, cfg)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "fused_fm", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/fused_fm.cu",
        "replaces": "deepfm_tpu/ops/pallas_fm.py:79",
        "launches": fm_launches, "max_abs_err": fm_err,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "ms_source": ms_source}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
