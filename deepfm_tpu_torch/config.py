"""Configuration system for deepfm_tpu_torch (a copy of ``deepfm_tpu.config``).

The port keeps its own copy, field for field, so that an artifact's
``model_config.json`` means the same thing to both packages. Flags that
name JAX or TPU machinery (``use_pallas``, ``mesh_*``, ``remat``) keep their
names: in the port ``use_pallas`` selects the hand-written CUDA FM kernel.

Reproduces the reference's full flag surface (``tf.app.flags`` definitions at
``1-ps-cpu/DeepFM-dist-ps-for-multipleCPU-multiInstance.py:35-71`` and
``2-hvd-gpu/DeepFM-hvd-tfrecord-vectorized-map.py:40-68``) as a single typed
dataclass with an argparse CLI front-end, plus environment-variable defaults
mirroring the SageMaker container contract (``SM_HOSTS``, ``SM_CURRENT_HOST``,
``SM_CHANNELS``, ``SM_NUM_CPUS`` — reference ``1-ps-cpu/...py:64-67,346``).

TPU-first deltas from the reference:
  * ``dist_mode`` selects the JAX process topology instead of TF_CONFIG roles.
  * ``mesh_data`` / ``mesh_model`` describe the 2-D device mesh (data
    parallelism x embedding row-sharding) instead of PS/Horovod knobs.
  * the MKL/OMP thread flags are replaced by host-pipeline worker counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence


#: Dense (count) columns that lead a ``--model dlrm_dcnv2`` row: Criteo's
#: integer features I1-I13.
DENSE_FEATURES = 13


def _int_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def _env_json(name: str, default: Any) -> Any:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, TypeError):
        return default


@dataclasses.dataclass
class Config:
    """Full training configuration.

    Field-by-field parity with the reference flag tables; reference flag name
    noted where it differs.
    """

    # ---- task & topology (reference: dist_mode, task_type) ----
    task_type: str = "train"          # train | eval | infer | export
    dist_mode: int = 0                # 0: single/auto, 1: local fake cluster, 2: multi-process
    num_processes: int = 1            # world size for dist_mode>0 (SM_HOSTS analog)
    process_id: int = 0               # this process's rank (SM_CURRENT_HOST analog)
    coordinator_address: str = ""     # jax.distributed coordinator (host:port)

    # ---- model hyperparameters (reference: model flags) ----
    model: str = "deepfm"             # deepfm | widedeep | dcnv2 | dlrm | din | bst | dlrm_dcnv2
    feature_size: int = 117581        # vocabulary size (reference ipynb:85)
    field_size: int = 39              # number of fields (reference ipynb:90)
    embedding_size: int = 32          # latent dim (reference flag default, ...py:44)
    deep_layers: str = "128,64,32"    # DNN tower widths (reference ipynb:90)
    dropout: str = "0.5,0.5,0.5"      # per-layer keep... reference semantics: dropout rates
    batch_norm: bool = False
    batch_norm_decay: float = 0.9
    cross_layers: int = 3             # DCN-v2 only: number of cross layers
    cross_rank: int = 0               # DCN-v2: low-rank dim for cross W (0 = full rank)
    l2_reg: float = 1e-4
    loss_type: str = "log_loss"       # log_loss | square_loss
    # ---- DLRM-DCNv2 (--model dlrm_dcnv2; MLPerf Training's recommendation
    #      model): the first DENSE_FEATURES columns of feat_vals feed a
    #      bottom MLP, the rest are per-feature multi-hot bags, each summed
    #      from a table of its own ----
    bottom_layers: str = ""           # bottom MLP widths, the last = embedding_size
    feature_hotness: str = ""         # ids in each feature's bag (comma list)
    table_rows: str = ""              # rows of each feature's table (comma list)

    # ---- multi-task ranking (README "Multi-task ranking", TUNING §2.12) ----
    # Comma list of task names. One name = the single-task zoo (--model
    # picks the graph); two names (e.g. "ctr,cvr") build the multi-task
    # model: task 0 reads the batch's `label` column, task 1 the optional
    # `label2` column.
    tasks: str = "ctr"
    # Per-task loss weights as a comma list ("" = all 1.0). Same length as
    # --tasks when set.
    task_weights: str = ""
    # Multi-task architecture: shared_bottom (one shared hidden stack,
    # per-task heads), mmoe (mixture-of-experts with per-task softmax
    # gates; Ma et al., KDD 2018), esmm (entire-space CTR+CVR; Ma et al.,
    # SIGIR 2018 — requires exactly the 2-task contract).
    multitask: str = "shared_bottom"  # shared_bottom | mmoe | esmm
    mmoe_experts: int = 4             # expert count for --multitask mmoe

    # ---- retrieval->ranking cascade (README "Retrieval→ranking cascade",
    #      TUNING §2.14) ----
    # User-history sequence length. 0 disables history; > 0 makes the
    # pipeline decode the optional ragged hist_ids/hist_vals TFRecord pair
    # into fixed [B, history_max_len] id/mask columns (padded/truncated)
    # that sequence models (din/bst) attend over. Incompatible with the
    # two-label multi-task contract and with embedding_update=sparse (the
    # sparse plan covers feat_ids only).
    history_max_len: int = 0
    # Candidate-index structure for the retrieval stage (rec/index.py):
    # "brute" = exact jit top-k over all item embeddings; "ann" = quantized
    # partition scan (approximate; recall@k is measured against brute force
    # and stamped into the exported index artifact).
    index_kind: str = "brute"

    # ---- optimization ----
    optimizer: str = "Adam"           # Adam | Adagrad | exact_adagrad | Momentum | ftrl
    learning_rate: float = 5e-4
    scale_lr_by_world: bool = True    # reference hvd: lr * hvd.size() (2-hvd-gpu/...py:149)
    num_epochs: int = 1
    batch_size: int = 1024            # GLOBAL batch size (split over data axis)

    # ---- input pipeline (reference: pipe_mode, shard flags) ----
    data_dir: str = ""
    val_data_dir: str = ""
    pipe_mode: int = 0                # 0: file mode, 1: streaming mode (Pipe analog)
    channels: str = ""                # JSON list of channel names (SM_CHANNELS analog)
    enable_s3_shard: bool = False     # files pre-sharded per process (ShardedByS3Key analog)
    enable_data_multi_path: bool = False  # one channel/dir per local worker (hvd flag ...py:68)
    worker_per_host: int = 1          # reference 2-hvd-gpu/...py:64
    shuffle_buffer: int = 10000
    shuffle_files: bool = True
    drop_remainder: bool = True
    prefetch_batches: int = 4
    reader_threads: int = 4           # host decode parallelism (MKL/OMP analog)
    # Decode worker PROCESSES feeding shared-memory slabs (0 = in-process
    # decode). Threads stop helping once the GIL-bound shuffle/stage work
    # dominates; processes sidestep the GIL entirely (see TUNING.md
    # "input_workers vs reader_threads"). Needs the native decoder; batch
    # order is bit-identical to the in-process path at equal seeds.
    input_workers: int = 0
    # Decoded-epoch cache (data/cache.py): frame+decode once, serve later
    # epochs from contiguous column slabs through the same shuffle pool.
    # "ram" holds the columns in-process; "disk" persists memory-mapped
    # .npy slabs under decoded_cache_dir (default: <model_dir>/decoded_cache)
    # keyed by a dataset fingerprint — stale entries rebuild automatically.
    decoded_cache: str = "off"        # off | ram | disk
    decoded_cache_dir: str = ""
    # Device-resident dataset (train/loop.py): when the decoded epoch fits
    # device_dataset_hbm_fraction of accelerator memory, upload the columns
    # once and run each epoch as an on-device multi-step program — zero
    # per-step host->device traffic. Falls back to the staged path with a
    # RuntimeWarning when over budget or feature-incompatible.
    device_dataset: bool = False
    device_dataset_hbm_fraction: float = 0.6
    use_native_decoder: bool = True   # C++ TFRecord decode path
    # Fused decode->assemble: one C call per shuffle-pool drain writes
    # decoded records straight into the transfer-layout pool. Kill switch
    # only — emission is bit-identical with it off (per-chunk scatter) —
    # but it is part of the consumption-layout fingerprint so a resumed
    # run never mixes probe outcomes mid-epoch. No-op without the native
    # decoder or on a stale prebuilt .so lacking the entry point.
    native_assembly: bool = True
    # CRC32C-check every record. Default False for speed: skipping the
    # check buys ~15-20% host decode throughput on a 1-core host (TUNING.md).
    # NOTE this is a deliberate parity DEVIATION, not parity: TF's record
    # reader does verify the length-field CRC (and data CRC unless the
    # dataset opts out), so the reference pipeline was checking. Flip on
    # for untrusted or long-haul-transferred data.
    verify_crc: bool = False
    steps_per_loop: int = 8           # optimizer steps per host dispatch (lax.scan)
    transfer_ahead: int = 2           # host->device staging depth (batches ahead)
    # Device staging slots (TUNING §2.13). 2 = double-buffered: the staging
    # thread transfers dispatch k+1's superbatch into the free slot while
    # the device computes dispatch k, fencing on slot reuse (transfer k
    # blocks until dispatch k-2 completed ON device). 1 = single-buffered:
    # every transfer fences on the previous dispatch's completion — H2D
    # serializes with compute (the A/B baseline, and an HBM escape hatch
    # when two staged superbatches don't fit). The trajectory is
    # bit-identical either way; only timing moves.
    staging_buffers: int = 2          # 1 | 2 device staging slots
    # Gradient accumulation (TUNING §2.13): accumulate this many microbatch
    # gradients (each a full --batch_size batch) before ONE optimizer
    # apply — effective batch = batch_size * grad_accum_steps * data
    # parallelism, at one microbatch of activation memory. state.step and
    # every step-counted cadence (log/save/resume) keep counting
    # MICROBATCHES; Adam's bias-correction count ticks once per apply.
    grad_accum_steps: int = 1         # microbatches per optimizer apply
    # ---- fault tolerance (I/O layer; see README "Fault tolerance") ----
    on_bad_record: str = "raise"      # raise | skip corrupt/truncated records
    max_bad_records: int = 0          # skip budget when skipping (0 = unlimited)
    io_retries: int = 4               # attempts per I/O op (1 = no retry)
    io_retry_backoff_secs: float = 0.1  # base of exponential full-jitter backoff
    io_retry_deadline_secs: float = 0.0  # per-op wall-clock cap (0 = none)
    # ---- training-runtime resilience (see README "Preemption & self-healing") ----
    # Policy for a non-finite loss / non-finite params after a dispatch:
    # abort raises (checked at log cadence — free); skip drops the poisoned
    # dispatch's update; rollback restores the last checkpoint and replays
    # from its recorded offset. skip/rollback sync the loss every dispatch.
    on_nonfinite: str = "abort"       # abort | skip | rollback
    max_rollbacks: int = 3            # shared skip+rollback budget per run
    # Abort (exit code 43) when no dispatch completes within this many
    # seconds; also bounds input-worker ring reads. 0 disables.
    dispatch_timeout_s: float = 0.0
    # Warn + count when |loss - EMA| exceeds this many EMA std-devs
    # (after warmup). Advisory only; 0 disables.
    loss_spike_zscore: float = 0.0
    # ---- online training & hot publishing (README "Online training") ----
    # Continuous training: the train channel is an UNBOUNDED stream — a
    # directory (or manifest file) that keeps receiving TFRecord shards
    # (data/stream.py tails it; a high-water-mark sidecar in model_dir
    # makes restarts replay-exact). Requires pipe_mode=1. The run ends on
    # SIGTERM (exit 42, resumable) or after stream_idle_timeout_secs
    # without new data.
    online_mode: bool = False
    # Publish a servable artifact (delta params checkpoint + export) every
    # N steps / secs into publish_dir (default: <model_dir>/publish),
    # atomically, off the training hot path. 0 disables that cadence.
    publish_every_steps: int = 0
    publish_every_secs: float = 0.0
    publish_dir: str = ""
    # A publish still in flight after this long trips the watchdog (exit
    # 43) — same contract as dispatch_timeout_s. 0 disables.
    publish_timeout_s: float = 600.0
    # Sliding eval window for the online AUC: slices older than this many
    # steps are evicted. 0 = cumulative (never evict).
    online_eval_window_steps: int = 0
    # Stream watcher cadence: how often the source is re-listed for new
    # shards, and how long with no new data before the stream reports EOF
    # (0 = wait forever; stop with SIGTERM).
    stream_poll_secs: float = 2.0
    stream_idle_timeout_secs: float = 0.0
    # ---- serving runtime (serve/; README "Serving") ----
    # Dynamic batcher policy: a flush fires when serve_max_batch rows are
    # queued (max-batch policy) or serve_max_delay_ms elapsed since the
    # FIRST queued request (deadline policy), whichever comes first.
    serve_max_batch: int = 256
    serve_max_delay_ms: float = 5.0
    # Bounded request queue in ROWS; submit past it raises the typed
    # ServerOverloaded (backpressure, never a hang). 0 = 8 * serve_max_batch.
    serve_queue_rows: int = 0
    # Batch-shape buckets as a comma list ("8,32,256"); every flush pads to
    # the next bucket so at most len(buckets) predict programs compile.
    # "" = the power-of-two ladder up to serve_max_batch.
    serve_buckets: str = ""
    # Frontend wedge watchdog: a predict or response write stalled past this
    # many seconds aborts with exit code 43 (same contract as
    # dispatch_timeout_s). 0 disables.
    serve_timeout_s: float = 0.0
    # Pipelined batching depth: how many formed flushes may be handed off
    # but not yet completed. 1 = strict flush-then-refill (the pre-pipeline
    # engine); 2 (default) forms flush k+1 while flush k executes.
    serve_inflight: int = 2
    # Priority lane: requests of at most this many rows get head-of-line
    # bypass into every forming batch (never stranded behind a max-batch
    # fill of large requests). 0 disables the lane.
    serve_small_rows: int = 0
    # ---- serving fast path (serve/cache.py; README "Serving fast path",
    # TUNING §2.20) ----
    # Version-keyed LRU result cache, capacity in ROWS (same unit as
    # serve_queue_rows): a request whose (ids, vals) bytes match a response
    # already flushed under the CURRENT model version resolves immediately,
    # bit-identical to the cached flush. Hot swaps invalidate for free
    # (the key carries the artifact version). 0 disables the cache.
    serve_cache_rows: int = 0
    # Cache entry TTL in seconds (lazy expiry at lookup). 0 = no TTL; LRU
    # eviction alone bounds staleness within a model version.
    serve_cache_ttl_s: float = 0.0
    # In-flight request coalescing: concurrent byte-identical requests
    # attach to one leader future; a single device execution fans out to
    # every joined caller. Off by default (exact pre-existing behavior).
    serve_coalesce: bool = False
    # Per-user tower-embedding cache in the cascade (entries = users): a
    # head user's repeat request skips the user-tower forward pass. Keyed
    # by (artifact version, history bytes) — swap-safe. 0 disables.
    serve_cache_user_rows: int = 0
    # Fused cascade program: collapse user-embed -> index top-k ->
    # candidate-substitute -> rank into ONE jitted per-bucket batch
    # program (device-side top-k, vectorized ITEM_SLOT substitution and
    # history fitting). Brute index only; falls back to the staged path
    # (counted) when the artifact can't fuse. Off by default.
    serve_fused_cascade: bool = False
    # ---- overload plane (serve/admission.py; README "Overload &
    # degradation", TUNING §2.18) ----
    # Per-request latency SLO: the admission gate sheds low-value classes
    # when the EWMA queue delay crosses half this budget. 0 disables the
    # delay signal (depth-only gating if a watermark is set).
    serve_slo_ms: float = 0.0
    # Queue-depth shed watermark in rows (pressure 1.0). 0 = half the
    # resolved serve_queue_rows. Either serve_slo_ms or
    # serve_shed_watermark > 0 arms the admission controller.
    serve_shed_watermark: int = 0
    # Request hedging floor (ReplicatedEngine): a request still pending
    # after max(this, fleet p99) ms is re-submitted to the least-loaded
    # other replica; first completion wins, the loser is cancelled and
    # counted. 0 disables hedging.
    serve_hedge_ms: float = 0.0
    # Degraded-mode candidate count (CascadeEngine): under pressure the
    # cascade first shrinks retrieve_k to this, then skips the ranker and
    # serves retrieval order. 0 disables the degradation ladder.
    degrade_retrieve_k: int = 0
    # ---- experimentation plane (serve/experiment.py + train/promote.py;
    # README "Experimentation & gated deployment", TUNING §2.19) ----
    # Traffic-split mode in front of the engine: off (single-arm), shadow
    # (challenger duplicated on an isolated side lane, response never
    # returned), canary (small live slice with an instant kill-switch), ab
    # (live split). Any mode but off needs a challenger artifact.
    experiment_mode: str = "off"
    # Seed of the pure hash-split arm assignment — same seed, same request
    # ids, same split, bit-for-bit (the replayability contract).
    experiment_seed: int = 0
    # Challenger traffic share in permille (0-1000), so a 0.5% canary (5)
    # is expressible. In shadow mode this is the duplication rate.
    experiment_permille: int = 50
    # Shadow-lane latency SLO in ms: a shadow response slower than this is
    # counted (shadow_slo_misses) — never waited on. 0 disables the count.
    experiment_shadow_slo_ms: float = 0.0
    # Promotion gates (train/promote.py): a candidate must pass EVERY gate
    # for this many consecutive health windows before LATEST advances; one
    # breach rolls it back; two failed candidacies quarantine the version.
    experiment_gate_windows: int = 2
    # Minimum per-arm samples for a window to be judged at all (thinner
    # windows hold — they neither advance nor demote).
    experiment_min_samples: int = 50
    # Gate thresholds: challenger AUC may trail control by at most
    # -min_auc_delta; challenger p99 must stay within max_p99_ratio x
    # control p99 AND under the absolute max_p99_ms ceiling (0 = off);
    # more than max_nonfinite NaN/Inf predictions is a
    # breach; |mean predicted - observed CTR| must stay under
    # max_calibration_err; a candidate older than max_candidate_age_s
    # (0 = off) breaches the staleness gate.
    experiment_min_auc_delta: float = -0.02
    experiment_max_p99_ratio: float = 1.5
    experiment_max_p99_ms: float = 0.0
    experiment_max_nonfinite: int = 0
    experiment_max_calibration_err: float = 0.2
    experiment_max_candidate_age_s: float = 0.0

    # ---- mesh / parallelism (replaces TF_CONFIG + horovod knobs) ----
    mesh_data: int = 0                # data-parallel axis size (0 = all devices)
    mesh_model: int = 1               # embedding row-shard axis size
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"   # MXU-friendly activations/matmuls
    remat: bool = False               # jax.checkpoint the DNN tower
    use_pallas: bool = True           # fused Pallas FM kernel when on TPU
    # Row-sharded lookup collective: masked_psum (traffic ∝ batch; the CTR
    # default) or allgather_table (traffic ∝ table; huge-batch/small-table
    # regimes). See TUNING.md "Sharded embedding lookup".
    embedding_lookup: str = "masked_psum"
    # ---- embedding scale (README "Embedding scale", TUNING §2.11) ----
    # Gradient application to the embedding tables: "dense" (the bit-exact
    # reference — full-table optimizer sweep every step) or "sparse" (dedup
    # the batch's ids, segment-sum cotangents, lazy timestamped Adam on the
    # touched rows only — step cost ∝ unique ids, not vocab). sparse
    # requires Adam and a single-device (1x1) mesh; L2 decays touched rows
    # only (documented deviation, tolerance-pinned against dense).
    embedding_update: str = "dense"   # dense | sparse
    # Hash-bucketed multi-table embeddings: comma list of per-table bucket
    # counts ("" = one monolithic feature_size table). N tables replace the
    # monolithic table; ids map to (table, bucket) by deterministic uint32
    # mixing, so feature_size may exceed any single allocation.
    embedding_buckets: str = ""
    # How ids pick their table in hashed mode: "hash" (id-mixed, balanced)
    # or "field" (field index mod N — per-field tables).
    embedding_assign: str = "hash"
    # Hot/cold tiered storage: "hot_cold" keeps an HBM-resident hot-row
    # cache (embedding_hot_rows slots) over a host-RAM cold store, with the
    # cold fetch for dispatch t+1 prefetched on the staging thread while
    # dispatch t computes. Requires embedding_update=sparse, the monolithic
    # table layout, and a single-device mesh.
    embedding_tiering: str = "off"    # off | hot_cold
    embedding_hot_rows: int = 0       # hot-cache capacity in rows (tiering)
    # Cold-store precision: float32; int8 or fp8_e4m3 store quantized rows
    # with a per-row dequant scale (fetch dequantizes, writeback
    # requantizes) at 1/4 the float32 host bytes. fp8 keeps ~2 mantissa
    # bits of relative precision per element vs int8's fixed grid.
    embedding_cold_dtype: str = "float32"  # float32 | int8 | fp8_e4m3
    # Sparse embedding-plane kernel selection (ops/pallas_embedding.py):
    # "auto" = Pallas kernels on TPU where the probe passes, the optimized
    # XLA legs (counting plan build, fused one-leaf backward, select
    # writeback, fused cache install) elsewhere; "pallas" forces Pallas
    # where possible; "xla" forces the optimized XLA legs even on TPU;
    # "off" is the kill switch — the seed formulation everywhere,
    # bit-for-bit. TUNING §2.11 has the selection table.
    embedding_kernels: str = "auto"   # auto | pallas | xla | off
    # Model-parallel row sharding of the embedding tables under the SPARSE
    # update path: "rows" partitions every logical table (monolithic or
    # hash-bucketed) contiguously over the model mesh axis with the
    # lazy-Adam moments sharded alongside, so per-device embedding HBM
    # drops ~1/mesh_model. Per step the batch's dedup plan is bucketed by
    # owner shard, request sets cross lax.all_to_all, owners gather and
    # update only their own rows, and a second all_to_all returns the
    # embeddings (ops/embedding.py exchange_*). On one device (or
    # mesh_model=1) this routes to the literal unsharded sparse program —
    # bit-identical by construction. TUNING §2.11 has the decision guide.
    embedding_shard: str = "off"      # off | rows

    # ---- checkpoint / export / logging ----
    model_dir: str = ""               # checkpoint dir (shared storage; reference :434)
    servable_model_dir: str = ""      # serving export dir (reference :52)
    clear_existing_model: bool = False  # reference 2-hvd-gpu/...py:60
    log_steps: int = 10               # reference flag :47 (value 10 in ipynb:90)
    save_checkpoints_steps: int = 1000
    keep_checkpoint_max: int = 3
    # Consecutive interval-save failures tolerated before aborting; each
    # failure logs and defers to the next interval (final forced save
    # always hard-fails). 0 = fail on the first save error.
    max_save_failures: int = 3
    eval_start_delay_secs: int = 0    # reference TrainSpec/EvalSpec (1-ps-cpu/...py:440-441)
    eval_throttle_secs: int = 0
    auc_num_thresholds: int = 200     # parity with tf.metrics.auc default
    seed: int = 42
    profile_dir: str = ""             # jax.profiler trace output ('' = disabled)
    # TensorBoard scalar summaries (loss/examples_per_sec at log_steps
    # cadence + per-eval AUC), chief-only — the Estimator summary-writer
    # analog ('' = disabled).
    tensorboard_dir: str = ""
    profile_steps: int = 20           # steps traced per run (bounded window)
    # Unified telemetry plane (obs/, TUNING.md §2.17). Span tracing over the
    # host seams (staging ring, input workers, serving batcher, publisher),
    # exported as Chrome trace_event JSON: off = every site a no-op,
    # ring = bounded buffer (wraparound drops counted), full = unbounded.
    trace: str = "off"
    trace_dir: str = ""               # trace JSON destination ('' = model_dir or cwd)
    trace_buffer: int = 65536         # ring capacity in events (trace=ring)
    # Periodic JSONL dump of the unified metrics registry (0 = off).
    metrics_snapshot_secs: float = 0.0

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        if self.task_type not in ("train", "eval", "infer", "export"):
            raise ValueError(f"unknown task_type: {self.task_type!r}")
        if self.trace not in ("off", "ring", "full"):
            raise ValueError(
                f"trace must be off|ring|full, got {self.trace!r}")
        if self.trace_buffer < 1:
            raise ValueError("trace_buffer must be >= 1")
        if self.metrics_snapshot_secs < 0:
            raise ValueError("metrics_snapshot_secs must be >= 0")
        if self.model not in ("deepfm", "widedeep", "dcnv2", "dlrm", "din",
                              "bst", "dlrm_dcnv2"):
            raise ValueError(f"unknown model: {self.model!r}")
        self._validate_dlrm_dcnv2()
        if self.history_max_len < 0:
            raise ValueError("history_max_len must be >= 0")
        if self.index_kind not in ("brute", "ann"):
            raise ValueError(
                f"index_kind must be brute|ann, got {self.index_kind!r}")
        if self.history_max_len > 0:
            if self.num_tasks > 1:
                raise ValueError(
                    "history_max_len > 0 is incompatible with multi-task "
                    "training (the stream carries ONE optional schema "
                    "extension: label2 OR hist_ids/hist_vals)")
            if self.embedding_update == "sparse":
                raise ValueError(
                    "history_max_len > 0 requires embedding_update=dense "
                    "(the sparse row plan covers feat_ids only, so history "
                    "gradients would be dropped)")
            if self.device_dataset:
                raise ValueError(
                    "history_max_len > 0 is incompatible with "
                    "device_dataset (history batches run the eager host "
                    "pipeline)")
            if self.pipe_mode == 1:
                raise ValueError(
                    "history_max_len > 0 requires file mode (pipe_mode=0); "
                    "the streaming pipeline does not decode the history "
                    "pair yet")
        names = self.task_names
        if not names:
            raise ValueError("tasks must name at least one task")
        if len(names) != len(set(names)):
            raise ValueError(f"task names must be unique, got {self.tasks!r}")
        if len(names) > 2:
            raise ValueError(
                "at most 2 tasks are supported (the input contract carries "
                f"label + label2), got {self.tasks!r}")
        if self.multitask not in ("shared_bottom", "mmoe", "esmm"):
            raise ValueError(
                f"multitask must be shared_bottom|mmoe|esmm, got "
                f"{self.multitask!r}")
        if self.mmoe_experts < 1:
            raise ValueError("mmoe_experts must be >= 1")
        try:
            weights = self.task_weight_values
        except ValueError as exc:
            raise ValueError(
                f"task_weights must be a comma list of floats, got "
                f"{self.task_weights!r}") from exc
        if len(weights) != len(names):
            raise ValueError(
                f"task_weights has {len(weights)} entries for "
                f"{len(names)} tasks ({self.tasks!r})")
        if any(w < 0 for w in weights):
            raise ValueError(
                f"task_weights must be >= 0, got {self.task_weights!r}")
        if self.optimizer.lower() not in ("adam", "adagrad", "exact_adagrad",
                                          "momentum", "ftrl", "sgd"):
            raise ValueError(f"unknown optimizer: {self.optimizer!r}")
        if self.loss_type not in ("log_loss", "square_loss"):
            raise ValueError(f"unknown loss_type: {self.loss_type!r}")
        if self.embedding_lookup not in ("masked_psum", "allgather_table"):
            raise ValueError(
                f"unknown embedding_lookup: {self.embedding_lookup!r}")
        if self.feature_size <= 0 or self.field_size <= 0 or self.embedding_size <= 0:
            raise ValueError("feature_size/field_size/embedding_size must be positive")
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.mesh_model < 1:
            raise ValueError("mesh_model must be >= 1")
        if self.steps_per_loop < 1:
            raise ValueError("steps_per_loop must be >= 1")
        if self.staging_buffers not in (1, 2):
            raise ValueError(
                f"staging_buffers must be 1 or 2, got {self.staging_buffers}")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if self.grad_accum_steps > 1:
            if self.steps_per_loop % self.grad_accum_steps != 0:
                raise ValueError(
                    f"grad_accum_steps={self.grad_accum_steps} must divide "
                    f"steps_per_loop={self.steps_per_loop} (each dispatch "
                    "covers a whole number of accumulation groups)")
            if self.device_dataset:
                raise ValueError(
                    "grad_accum_steps > 1 is not supported with "
                    "device_dataset (the on-device gather path applies the "
                    "optimizer per batch)")
            if self.embedding_tiering != "off":
                raise ValueError(
                    "grad_accum_steps > 1 is not supported with "
                    "embedding_tiering (the hot/cold planner transacts one "
                    "batch per optimizer step)")
        if self.on_bad_record not in ("raise", "skip"):
            raise ValueError(
                f"on_bad_record must be 'raise' or 'skip', "
                f"got {self.on_bad_record!r}")
        if self.max_bad_records < 0:
            raise ValueError("max_bad_records must be >= 0")
        if self.input_workers < 0:
            raise ValueError("input_workers must be >= 0")
        if self.io_retries < 1:
            raise ValueError("io_retries must be >= 1")
        if self.io_retry_backoff_secs < 0 or self.io_retry_deadline_secs < 0:
            raise ValueError("io retry backoff/deadline must be >= 0")
        if self.max_save_failures < 0:
            raise ValueError("max_save_failures must be >= 0")
        if self.on_nonfinite not in ("abort", "skip", "rollback"):
            raise ValueError(
                f"on_nonfinite must be abort|skip|rollback, got "
                f"{self.on_nonfinite!r}")
        if self.max_rollbacks < 0:
            raise ValueError("max_rollbacks must be >= 0")
        if self.dispatch_timeout_s < 0:
            raise ValueError("dispatch_timeout_s must be >= 0")
        if self.loss_spike_zscore < 0:
            raise ValueError("loss_spike_zscore must be >= 0")
        if self.publish_every_steps < 0 or self.publish_every_secs < 0:
            raise ValueError("publish_every_steps/secs must be >= 0")
        if self.publish_timeout_s < 0:
            raise ValueError("publish_timeout_s must be >= 0")
        if self.online_eval_window_steps < 0:
            raise ValueError("online_eval_window_steps must be >= 0")
        if self.stream_poll_secs <= 0:
            raise ValueError("stream_poll_secs must be > 0")
        if self.stream_idle_timeout_secs < 0:
            raise ValueError("stream_idle_timeout_secs must be >= 0")
        if self.online_mode and self.pipe_mode != 1:
            raise ValueError(
                "online_mode requires pipe_mode=1 (the unbounded stream "
                "source is a streaming-mode producer)")
        if self.online_mode and self.num_epochs != 1:
            raise ValueError(
                "online_mode streams each shard once; num_epochs must be 1")
        if self.serve_max_batch < 1:
            raise ValueError("serve_max_batch must be >= 1")
        if self.serve_max_delay_ms < 0:
            raise ValueError("serve_max_delay_ms must be >= 0")
        if self.serve_queue_rows < 0:
            raise ValueError("serve_queue_rows must be >= 0 (0 = auto)")
        if self.serve_queue_rows and self.serve_queue_rows < self.serve_max_batch:
            raise ValueError(
                "serve_queue_rows must hold at least one serve_max_batch")
        if self.serve_timeout_s < 0:
            raise ValueError("serve_timeout_s must be >= 0")
        if self.serve_inflight < 1:
            raise ValueError(
                "serve_inflight must be >= 1 (1 = strict flush-then-refill)")
        if not 0 <= self.serve_small_rows <= self.serve_max_batch:
            raise ValueError(
                "serve_small_rows must be in 0..serve_max_batch "
                f"(got {self.serve_small_rows} vs "
                f"serve_max_batch={self.serve_max_batch})")
        if self.serve_cache_rows < 0:
            raise ValueError("serve_cache_rows must be >= 0 (0 disables)")
        if self.serve_cache_ttl_s < 0:
            raise ValueError("serve_cache_ttl_s must be >= 0 (0 = no TTL)")
        if self.serve_cache_user_rows < 0:
            raise ValueError(
                "serve_cache_user_rows must be >= 0 (0 disables)")
        if self.serve_slo_ms < 0:
            raise ValueError("serve_slo_ms must be >= 0 (0 disables)")
        if self.serve_shed_watermark < 0:
            raise ValueError(
                "serve_shed_watermark must be >= 0 (0 = half the queue)")
        if self.serve_hedge_ms < 0:
            raise ValueError("serve_hedge_ms must be >= 0 (0 disables)")
        if self.degrade_retrieve_k < 0:
            raise ValueError(
                "degrade_retrieve_k must be >= 0 (0 disables the ladder)")
        if self.experiment_mode not in ("off", "shadow", "canary", "ab"):
            raise ValueError(
                f"experiment_mode must be off|shadow|canary|ab, got "
                f"{self.experiment_mode!r}")
        if not 0 <= self.experiment_permille <= 1000:
            raise ValueError(
                f"experiment_permille must be in 0..1000, got "
                f"{self.experiment_permille}")
        if self.experiment_shadow_slo_ms < 0:
            raise ValueError(
                "experiment_shadow_slo_ms must be >= 0 (0 disables)")
        if self.experiment_gate_windows < 1:
            raise ValueError(
                f"experiment_gate_windows must be >= 1, got "
                f"{self.experiment_gate_windows}")
        if self.experiment_min_samples < 1:
            raise ValueError(
                f"experiment_min_samples must be >= 1, got "
                f"{self.experiment_min_samples}")
        if self.experiment_max_p99_ratio <= 0:
            raise ValueError(
                f"experiment_max_p99_ratio must be > 0, got "
                f"{self.experiment_max_p99_ratio}")
        if self.experiment_max_p99_ms < 0:
            raise ValueError(
                "experiment_max_p99_ms must be >= 0 (0 disables)")
        if self.experiment_max_nonfinite < 0:
            raise ValueError(
                f"experiment_max_nonfinite must be >= 0, got "
                f"{self.experiment_max_nonfinite}")
        if self.experiment_max_calibration_err < 0:
            raise ValueError(
                f"experiment_max_calibration_err must be >= 0, got "
                f"{self.experiment_max_calibration_err}")
        if self.experiment_max_candidate_age_s < 0:
            raise ValueError(
                "experiment_max_candidate_age_s must be >= 0 (0 disables)")
        bucket_sizes = self.serve_bucket_sizes
        if any(b < 1 for b in bucket_sizes):
            raise ValueError(
                f"serve_buckets must be positive ints, got {self.serve_buckets!r}")
        if bucket_sizes and max(bucket_sizes) > self.serve_max_batch:
            raise ValueError(
                f"serve_buckets {self.serve_buckets!r} exceeds "
                f"serve_max_batch={self.serve_max_batch}")
        if self.embedding_update not in ("dense", "sparse"):
            raise ValueError(
                f"embedding_update must be dense|sparse, got "
                f"{self.embedding_update!r}")
        if self.embedding_update == "sparse":
            if self.optimizer.lower() not in ("adam", "exact_adagrad"):
                raise ValueError(
                    "embedding_update=sparse implements the row update for "
                    "two optimizers: Adam (lazy, timestamped) and "
                    "exact_adagrad; use --optimizer Adam, --optimizer "
                    "exact_adagrad or --embedding_update dense")
            if self.optimizer.lower() == "exact_adagrad" and (
                    self.embedding_tiering != "off"
                    or self.embedding_shard == "rows"
                    or self.grad_accum_steps > 1):
                raise ValueError(
                    "embedding_update=sparse with exact_adagrad runs on one "
                    "card's sparse step only: no --embedding_tiering, "
                    "--embedding_shard rows or --grad_accum_steps > 1 (their "
                    "row planes carry lazy Adam's slots)")
            if self.mesh_model > 1 and self.embedding_shard != "rows":
                raise ValueError(
                    "embedding_update=sparse under mesh_model>1 needs the "
                    "row-exchange plane: set --embedding_shard rows (or "
                    "--embedding_update dense)")
        try:
            buckets = self.embedding_bucket_sizes
        except ValueError as exc:
            raise ValueError(
                f"embedding_buckets must be a comma list of positive ints, "
                f"got {self.embedding_buckets!r}") from exc
        if any(b < 1 for b in buckets):
            raise ValueError(
                f"embedding_buckets must be positive ints, got "
                f"{self.embedding_buckets!r}")
        if buckets and self.mesh_model > 1:
            if self.embedding_shard != "rows":
                raise ValueError(
                    "hash-bucketed multi-table embeddings (embedding_"
                    "buckets) row-shard only via --embedding_shard rows; "
                    "otherwise mesh_model must be 1")
            bad = [b for b in buckets if b % self.mesh_model]
            if bad:
                raise ValueError(
                    f"embedding_shard=rows needs every bucket count "
                    f"divisible by mesh_model={self.mesh_model}; "
                    f"got {bad}")
        if self.embedding_assign not in ("hash", "field"):
            raise ValueError(
                f"embedding_assign must be hash|field, got "
                f"{self.embedding_assign!r}")
        if self.embedding_tiering not in ("off", "hot_cold"):
            raise ValueError(
                f"embedding_tiering must be off|hot_cold, got "
                f"{self.embedding_tiering!r}")
        if self.embedding_cold_dtype not in ("float32", "int8", "fp8_e4m3"):
            raise ValueError(
                f"embedding_cold_dtype must be float32|int8|fp8_e4m3, got "
                f"{self.embedding_cold_dtype!r}")
        if self.embedding_kernels not in ("auto", "pallas", "xla", "off"):
            raise ValueError(
                f"embedding_kernels must be auto|pallas|xla|off, got "
                f"{self.embedding_kernels!r}")
        if self.embedding_shard not in ("off", "rows"):
            raise ValueError(
                f"embedding_shard must be off|rows, got "
                f"{self.embedding_shard!r}")
        if self.embedding_shard == "rows":
            if self.embedding_update != "sparse":
                raise ValueError(
                    "embedding_shard=rows rides the sparse row plane; set "
                    "--embedding_update sparse")
            if self.embedding_tiering != "off":
                raise ValueError(
                    "embedding_shard=rows and embedding_tiering are "
                    "mutually exclusive (pick HBM capacity from more chips "
                    "OR from the host cold store — TUNING §2.11)")
            if self.grad_accum_steps > 1:
                raise ValueError(
                    "embedding_shard=rows does not compose with "
                    "grad_accum_steps > 1 yet (the merged-plan accumulation "
                    "path is single-device)")
            if self.device_dataset:
                raise ValueError(
                    "embedding_shard=rows is not supported with "
                    "device_dataset (the on-device gather feed is "
                    "single-device)")
        if self.embedding_tiering == "hot_cold":
            if self.embedding_update != "sparse":
                raise ValueError(
                    "embedding_tiering=hot_cold requires "
                    "embedding_update=sparse (the hot cache only holds rows "
                    "the sparse update touches)")
            if buckets:
                raise ValueError(
                    "embedding_tiering=hot_cold supports the monolithic "
                    "table layout only (unset embedding_buckets)")
            if self.embedding_hot_rows < 1:
                raise ValueError(
                    "embedding_tiering=hot_cold needs embedding_hot_rows "
                    ">= 1 (hot-cache capacity)")
            if self.embedding_hot_rows >= self.feature_size:
                raise ValueError(
                    "embedding_hot_rows >= feature_size: the whole table "
                    "fits in HBM — turn tiering off")
            if self.device_dataset:
                raise ValueError(
                    "embedding_tiering=hot_cold and device_dataset are "
                    "mutually exclusive (tiering owns the staged feed)")
            if self.on_nonfinite == "rollback":
                raise ValueError(
                    "embedding_tiering=hot_cold does not support "
                    "on_nonfinite=rollback (checkpoints capture only the "
                    "hot tier); use abort or skip")
            if self.online_mode:
                raise ValueError(
                    "embedding_tiering=hot_cold does not support "
                    "online_mode yet (published artifacts would hold only "
                    "the hot tier)")
        if self.decoded_cache not in ("off", "ram", "disk"):
            raise ValueError(
                f"decoded_cache must be off|ram|disk, got "
                f"{self.decoded_cache!r}")
        if not 0.0 < self.device_dataset_hbm_fraction <= 1.0:
            raise ValueError(
                "device_dataset_hbm_fraction must be in (0, 1]")
        if self.device_dataset and self.decoded_cache == "off":
            raise ValueError(
                "device_dataset requires decoded_cache=ram|disk (the device "
                "upload reads the cached columns)")

    def _validate_dlrm_dcnv2(self) -> None:
        """The per-feature fields name one another and the model: set
        together, for ``--model dlrm_dcnv2`` only, on its one layout."""
        try:
            sizes = (self.bottom_layer_sizes, self.feature_hotness_values,
                     self.table_row_counts)
        except ValueError as exc:
            raise ValueError(
                "bottom_layers, feature_hotness and table_rows must be comma "
                "lists of positive ints") from exc
        bottom, hotness, rows = sizes
        if self.model != "dlrm_dcnv2":
            if bottom or hotness or rows:
                raise ValueError(
                    "bottom_layers, feature_hotness and table_rows belong to "
                    "--model dlrm_dcnv2")
            return
        if not (bottom and hotness and rows):
            raise ValueError(
                "--model dlrm_dcnv2 needs bottom_layers, feature_hotness and "
                "table_rows")
        if any(x < 1 for x in (*bottom, *hotness, *rows)):
            raise ValueError(
                "bottom_layers, feature_hotness and table_rows must be "
                "positive")
        if len(hotness) != len(rows):
            raise ValueError(
                f"feature_hotness has {len(hotness)} features and table_rows "
                f"{len(rows)}: one table per feature")
        if self.field_size != DENSE_FEATURES + sum(hotness):
            raise ValueError(
                f"--model dlrm_dcnv2 reads {DENSE_FEATURES} dense columns and "
                f"then each feature's bag: field_size must be "
                f"{DENSE_FEATURES + sum(hotness)}, got {self.field_size}")
        if bottom[-1] != self.embedding_size:
            raise ValueError(
                f"the bottom MLP's last width ({bottom[-1]}) must be "
                f"embedding_size ({self.embedding_size}): it sits beside the "
                "pooled bags in the cross network's input")
        if self.embedding_buckets:
            raise ValueError("--model dlrm_dcnv2 keeps one table per feature: "
                             "unset embedding_buckets")
        if self.embedding_tiering != "off":
            raise ValueError("--model dlrm_dcnv2 keeps its tables on the "
                             "device: --embedding_tiering off")
        if self.embedding_update != "sparse":
            raise ValueError("--model dlrm_dcnv2 trains with "
                             "--embedding_update sparse (dense tables, their "
                             "gradients and the optimizer's slots do not fit)")
        if (self.mesh_model > 1 or self.embedding_shard == "rows"
                or self.num_tasks > 1 or self.history_max_len > 0):
            raise ValueError("--model dlrm_dcnv2 runs one task on one model "
                             "rank: no --mesh_model, --embedding_shard rows, "
                             "multi-task or history")

    # ---- derived views ------------------------------------------------
    @property
    def bottom_layer_sizes(self) -> List[int]:
        return _int_list(self.bottom_layers)

    @property
    def feature_hotness_values(self) -> List[int]:
        return _int_list(self.feature_hotness)

    @property
    def table_row_counts(self) -> List[int]:
        return _int_list(self.table_rows)

    @property
    def deep_layer_sizes(self) -> List[int]:
        return [int(x) for x in self.deep_layers.split(",") if x.strip()]

    @property
    def dropout_rates(self) -> List[float]:
        return [float(x) for x in self.dropout.split(",") if x.strip()]

    @property
    def task_names(self) -> List[str]:
        return [t.strip() for t in self.tasks.split(",") if t.strip()]

    @property
    def num_tasks(self) -> int:
        return len(self.task_names)

    @property
    def task_weight_values(self) -> List[float]:
        vals = [float(x) for x in self.task_weights.split(",") if x.strip()]
        if not vals:
            return [1.0] * self.num_tasks
        return vals

    @property
    def serve_bucket_sizes(self) -> List[int]:
        return [int(x) for x in self.serve_buckets.split(",") if x.strip()]

    @property
    def embedding_bucket_sizes(self) -> List[int]:
        return [int(x) for x in self.embedding_buckets.split(",") if x.strip()]

    @property
    def channel_names(self) -> List[str]:
        if not self.channels:
            return []
        val = self.channels
        if isinstance(val, str):
            try:
                parsed = json.loads(val)
            except json.JSONDecodeError:
                parsed = [c for c in val.split(",") if c]
            return list(parsed)
        return list(val)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _add_bool_arg(p: argparse.ArgumentParser, name: str, default: bool, help_: str) -> None:
    p.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                   default=default, help=help_)


def build_arg_parser(defaults: Optional[Config] = None) -> argparse.ArgumentParser:
    """argparse mirror of the dataclass; hyperparameter-dict→argv compatible.

    The SageMaker launcher passed hyperparameters as ``--key value`` argv
    (reference ``deepfm-sagemaker-ps-cpu.ipynb:89-95``); this parser accepts
    the same shape.
    """
    d = defaults or Config()
    p = argparse.ArgumentParser("deepfm_tpu", description="TPU-native DeepFM trainer")
    for f in dataclasses.fields(Config):
        default = getattr(d, f.name)
        if f.type == "bool" or isinstance(default, bool):
            _add_bool_arg(p, f.name, default, f"(default: {default})")
        elif isinstance(default, int):
            p.add_argument(f"--{f.name}", type=int, default=default)
        elif isinstance(default, float):
            p.add_argument(f"--{f.name}", type=float, default=default)
        else:
            p.add_argument(f"--{f.name}", type=str, default=default)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    # Environment defaults mirroring the SageMaker env contract.
    env = Config(
        channels=os.environ.get("SM_CHANNELS", ""),
        data_dir=os.environ.get("SM_CHANNEL_TRAINING", ""),
        val_data_dir=os.environ.get("SM_CHANNEL_EVAL", ""),
        model_dir=os.environ.get("DEEPFM_MODEL_DIR", ""),
        num_processes=len(_env_json("SM_HOSTS", [None])) or 1,
    )
    ns = build_arg_parser(env).parse_args(argv)
    return Config.from_dict(vars(ns))
