"""Tasks: train / eval / infer / export on one device or one GPU per
process of a data-parallel group (port of ``deepfm_tpu.train.tasks``).

  * ``train`` — per-epoch train loop with an eval after each epoch (or,
    with ``--eval_start_delay_secs``/``--eval_throttle_secs``, throttled
    mid-train evals and a final one), a checkpoint every
    ``save_checkpoints_steps`` (asynchronous: ``utils.checkpoint``) and a
    forced one at the end, resume from the latest checkpoint in
    ``model_dir`` (mid-epoch exact through the ``resume_meta.json``
    sidecar, written only once its checkpoint is durable),
    ``clear_existing_model``, and a final serving export when
    ``servable_model_dir`` is set. It polls the process-wide preemption
    listener once per dispatch: on SIGTERM/SIGINT (or the injectable
    trigger) it force-saves a checkpoint and the sidecar, then raises
    ``utils.preempt.Preempted`` (the launcher exits 42). Under
    ``--on_nonfinite rollback`` a :class:`RollbackSignal` from the fit loop
    restores the latest checkpoint and replays from its recorded offset
    (one attempt after another, bounded by the guard's ``--max_rollbacks``
    budget).
  * Pipe mode (``--pipe_mode 1``) trains one ``fit`` over one single-pass
    stream (``make_streaming_pipeline``), the epochs replayed by the
    producer; the resume position is steps into the stream.
  * Online mode (``--online_mode``, with pipe mode) tails a directory that
    keeps receiving shards (``make_online_pipeline``, ``data.stream``) and
    ends on preemption or after ``--stream_idle_timeout_secs`` without new
    data. With ``--publish_every_steps``/``--publish_every_secs`` a
    :class:`~.publish.Publisher` publishes servable versions into
    ``--publish_dir`` (default ``<model_dir>/publish``) for
    ``ServingEngine.serve_latest`` to hot-swap, drains before exit 42 and
    forces a final publish at the terminal step;
    ``--online_eval_window_steps`` reports a sliding-window AUC.
  * ``--tensorboard_dir`` writes scalar summaries (``obs.tensorboard``);
    ``--profile_dir`` traces a window of ``--profile_steps`` steps with
    ``torch.profiler`` (``utils.profiling.StepWindowTracer``).
  * ``eval`` — AUC + loss on the eval files (and ``auc_<task>`` per task
    of a multi-task model).
  * ``infer`` — one probability per line to ``pred.txt`` (one
    space-separated column per task of a multi-task model). A sequence
    model reads the records' history, as its eval does (the JAX package's
    infer pipeline leaves the history out).
  * ``export`` — the servable artifact of the latest checkpoint, through
    ``utils.export.export_serving``: what ``serve.ServingEngine`` loads.

Files resolve as in the JAX package: ``tr*`` / ``va*`` / ``te*`` +
``.tfrecords``, falling back to every ``*.tfrecords`` in the directory.

``run(cfg, device="cuda")`` runs on the card unless the caller asks for
the CPU. It bootstraps the process group (``parallel.bootstrap``) under
``--dist_mode 1|2``. Under more than one process:

  * ``batch_size`` is global: each rank reads ``batch_size / world`` rows
    (``_local_batch_size``) from its share of the files (``data.sharding``
    ``shard_files``: the reference's multi_path x s3_shard matrix; with
    fewer files than ranks a record shard), checked for coverage at start;
    ``--enable_data_multi_path`` gives each local worker its own channel.
  * Only the chief clears ``model_dir`` (the others wait at a barrier),
    checkpoints, exports and writes ``pred.txt``; every rank restores the
    same checkpoint. The resume position is decided on the chief and
    broadcast.
  * The throttled eval and the preemption poll consult the clock and the
    flag only at agreed dispatches (``_eval_check_due``): the chief's eval
    verdict is broadcast and the preemption flag is ORed over the ranks, so
    every rank evaluates, saves and stops at the same dispatch.
  * Infer predicts a record shard per rank, gathers the predictions to
    every rank and re-interleaves them into global record order.
  * ``--online_mode`` raises ``NotImplementedError``, as the JAX package's
    does.

Under a model axis (``--mesh_data D --mesh_model M``, D * M processes,
``parallel.mesh``) the files, the records and ``batch_size / D`` rows are
sharded by the DATA index over D, so the M model peers of a mesh row read
the same batches; eval sums its metrics over the data ranks; infer keeps
the predictions of model index 0, re-interleaved over the data ranks. A
checkpoint holds the full tables (``Trainer.full_state``, a collective on
every rank; the chief writes) and a restore cuts them to the rank's rows
(``Trainer.local_snapshot``), so a checkpoint restores on any mesh; an
export gathers the tables first and writes the one-device artifact.
``check_task_ported`` checks the mesh against ``--num_processes`` before
any process group starts.

Every pipeline takes the input flags: the native decoder and its pooled
emission (``--use_native_decoder``, ``--native_assembly``,
``--reader_threads``), the decoded-epoch cache (``--decoded_cache``,
``--decoded_cache_dir``, default ``<model_dir>/decoded_cache``), the
bad-record policy (``--on_bad_record``, ``--max_bad_records``) and read
retries (``--io_retries``, ``--io_retry_backoff_secs``,
``--io_retry_deadline_secs``) and the input service (``--input_workers``:
decode worker processes, ``data.workers``). ``--device_dataset`` trains
each epoch through ``Trainer.fit_device_resident`` when the run
qualifies, and warns and stages when it does not. The train result carries the run's
``read_retries`` and ``bad_records``.

Under hot/cold tiering (``--embedding_tiering hot_cold``) every checkpoint
is written DENSIFIED (``TieredEmbeddingRuntime.checkpoint_state``: full
tables and full-shape lazy-Adam slots), so it restores bit-exactly into an
untiered run and back; a tiered task restores into the dense template and
then adopts the state into its tier. The exported artifact holds the full
tables, and the train result carries the tier's ``hotcold_*`` stats.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import json
import logging
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..data import cache as cache_lib
from ..data import fileio
from ..data import pipeline as pipe_lib
from ..data import sharding as shard_lib
from ..data import stream as stream_lib
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.tensorboard import TensorBoardWriter
from ..parallel import bootstrap
from ..parallel import mesh as mesh_lib
from ..utils import checkpoint as ckpt_lib
from ..utils import export as export_lib
from ..utils import faults as faults_lib
from ..utils import preempt as preempt_lib
from ..utils import profiling as prof_lib
from ..utils import retry as retry_lib
from . import guard as guard_lib
from . import metrics as metrics_lib
from . import publish as publish_lib
from .loop import Trainer, check_ported, pad_batch, zero_batch
from .state import TrainState

log = logging.getLogger(__name__)


def check_task_ported(cfg: Config) -> None:
    """The tasks' check before any process group starts: the
    Trainer's (``check_ported``: the mesh must cover ``--num_processes``,
    else ``ValueError`` naming the flags)."""
    check_ported(cfg)


def _data_axis(cfg: Config) -> Tuple[int, int]:
    """(data index, data size) of this process: the mesh row's index and
    the number of rows (``parallel.mesh``); (rank, world) without a model
    axis."""
    world = bootstrap.process_count()
    if world == 1:
        return 0, 1
    _, model = mesh_lib.mesh_shape(cfg, world)
    return bootstrap.process_index() // model, world // model


def _data_workers_per_host(cfg: Config) -> int:
    """Data ranks per host: ``worker_per_host`` over the model axis (model
    peers are adjacent ranks, so a host holds whole mesh rows)."""
    return max(max(cfg.worker_per_host, 1) // max(cfg.mesh_model, 1), 1)


def resolve_files(directory: str, prefix: str) -> List[str]:
    """Glob ``{prefix}*.tfrecords``; fall back to all ``*.tfrecords``."""
    if not directory:
        return []
    files = _glob.glob(os.path.join(directory, f"{prefix}*.tfrecords"))
    if not files:
        files = _glob.glob(os.path.join(directory, "*.tfrecords"))
    return sorted(files)


def _channel_path(cfg: Config, name: str, *, require: bool = False) -> str:
    """A channel's directory: ``$SM_CHANNEL_<NAME>`` when set, else a
    ``<data_dir>/<name>`` subdirectory, else ``data_dir``. ``require``
    (multi-path channels) makes the last fallback an error: resolving every
    worker's private channel to the shared ``data_dir`` would train the
    same records on every local worker."""
    env_key = "SM_CHANNEL_" + "".join(
        c if c.isalnum() else "_" for c in name).upper()
    if os.environ.get(env_key):
        return os.environ[env_key]
    sub = os.path.join(cfg.data_dir, name) if cfg.data_dir else ""
    if sub and os.path.isdir(sub):
        return sub
    if require:
        raise FileNotFoundError(
            f"channel {name!r} resolves to neither ${env_key} nor "
            f"{sub or '<data_dir>/' + name!r}; enable_data_multi_path needs "
            f"a real private directory per training channel")
    return cfg.data_dir


def resolve_channel_dirs(cfg: Config, *, process_index: Optional[int] = None
                         ) -> Tuple[str, str]:
    """(train_dir, eval_dir) for this process. With SageMaker-style
    channels (eval channel first, reference ``2-hvd-gpu/...py:376-380,
    403``) each resolves through :func:`_channel_path`; under
    ``enable_data_multi_path`` local worker ``rank % worker_per_host``
    reads its own training channel ``channel_names[1 + local_rank]``."""
    names = cfg.channel_names
    eval_default = cfg.val_data_dir or cfg.data_dir
    if not names:
        return cfg.data_dir, eval_default
    eval_dir = (_channel_path(cfg, names[0])
                if len(names) > 1 else eval_default)
    train_names = names[1:] if len(names) > 1 else names
    wph = max(cfg.worker_per_host, 1)
    if cfg.enable_data_multi_path:
        if len(train_names) < wph:
            raise ValueError(
                f"enable_data_multi_path needs one training channel per "
                f"local worker: have {len(train_names)} channels "
                f"{train_names} for worker_per_host={wph} "
                f"(reference contract, README-EN.md:82)")
        rank = (_data_axis(cfg)[0] if process_index is None
                else process_index)
        train_dir = _channel_path(
            cfg, train_names[rank % _data_workers_per_host(cfg)],
            require=True)
    else:
        train_dir = _channel_path(cfg, train_names[0])
    return train_dir, eval_dir


def _local_batch_size(cfg: Config, world: Optional[int] = None) -> int:
    """This rank's (or each of ``world`` data ranks') rows of the global
    ``batch_size``."""
    return mesh_lib.local_batch_size(
        cfg, _data_axis(cfg)[1] if world is None else world)


def _shard_spec(cfg: Config, files: List[str], rank: Optional[int] = None,
                world: Optional[int] = None) -> shard_lib.ShardSpec:
    """This rank's (or data rank ``rank``'s of ``world``) share of
    ``files``: the data index's, the same on its model peers."""
    if rank is None or world is None:
        index, size = _data_axis(cfg)
        rank = index if rank is None else rank
        world = size if world is None else world
    wph = _data_workers_per_host(cfg)
    return shard_lib.shard_files(
        files, enable_data_multi_path=cfg.enable_data_multi_path,
        enable_s3_shard=cfg.enable_s3_shard, rank=rank,
        local_rank=rank % wph, world_size=world, workers_per_host=wph)


def _validate_shard_coverage(cfg: Config, files: List[str]) -> None:
    """Start-up guard of a multi-process run: the ranks' shard specs cover
    every training file exactly once (every rank derives all the specs
    and checks the same thing). Under ``enable_s3_shard`` this host's
    local workers cover this host's files; private multi-path channels
    are not one list, so they are not checked."""
    world = _data_axis(cfg)[1]
    if world <= 1 or cfg.enable_data_multi_path:
        return
    if cfg.enable_s3_shard:
        ranks = range(min(_data_workers_per_host(cfg), world))
    else:
        ranks = range(world)
    specs = [_shard_spec(cfg, files, rank=r) for r in ranks]
    shard_lib.validate_shard_coverage(specs, sorted(files))


def _fault_tolerance_kwargs(cfg: Config) -> Dict:
    """Bad-record policy and I/O retry knobs of every pipeline build."""
    return dict(on_bad_record=cfg.on_bad_record,
                max_bad_records=cfg.max_bad_records,
                retry_policy=retry_lib.policy_from_config(cfg))


def _decoded_cache_dir(cfg: Config) -> str:
    """Disk-cache location: the flag, else ``<model_dir>/decoded_cache``."""
    if cfg.decoded_cache != "disk":
        return ""
    if cfg.decoded_cache_dir:
        return cfg.decoded_cache_dir
    if cfg.model_dir:
        return os.path.join(cfg.model_dir, "decoded_cache")
    raise ValueError("--decoded_cache disk needs --decoded_cache_dir "
                     "or --model_dir")


def make_pipeline(cfg: Config, files: List[str], *, epochs: int = 1,
                  shuffle: bool = True, sharded: bool = True,
                  drop_remainder: Optional[bool] = None,
                  epoch_offset: int = 0, skip_batches: int = 0,
                  rank: Optional[int] = None, world: Optional[int] = None,
                  shard: Optional[shard_lib.ShardSpec] = None
                  ) -> pipe_lib.CtrPipeline:
    """The file pipeline of this rank (or of ``rank`` of ``world``): its
    shard of ``files`` (``shard`` when given) at the local batch size."""
    if shard is None and sharded:
        shard = _shard_spec(cfg, files, rank=rank, world=world)
    return pipe_lib.CtrPipeline(
        sorted(files), field_size=cfg.field_size,
        batch_size=_local_batch_size(cfg, world), shard=shard,
        num_epochs=epochs, shuffle=shuffle,
        shuffle_files=shuffle and cfg.shuffle_files,
        shuffle_buffer=cfg.shuffle_buffer,
        drop_remainder=(cfg.drop_remainder if drop_remainder is None
                        else drop_remainder),
        seed=cfg.seed, prefetch_batches=cfg.prefetch_batches,
        use_native_decoder=cfg.use_native_decoder,
        native_assembly=cfg.native_assembly,
        reader_threads=cfg.reader_threads, verify_crc=cfg.verify_crc,
        epoch_offset=epoch_offset, skip_batches=skip_batches,
        decoded_cache=cfg.decoded_cache,
        decoded_cache_dir=_decoded_cache_dir(cfg),
        input_workers=cfg.input_workers,
        stall_timeout_s=cfg.dispatch_timeout_s,
        num_labels=cfg.num_tasks, history=cfg.history_max_len > 0,
        history_max_len=max(1, cfg.history_max_len),
        **_fault_tolerance_kwargs(cfg))


def _eval_pipeline(cfg: Config, va_files: List[str]) -> pipe_lib.CtrPipeline:
    """Eval reads every record: no shuffle, keep the tail batch (the eval
    step pads it with zero-weight rows)."""
    return make_pipeline(cfg, va_files, shuffle=False, drop_remainder=False)


def make_streaming_pipeline(cfg: Config, files: List[str], *, epochs: int = 1,
                            skip_batches: int = 0, epoch_offset: int = 0
                            ) -> pipe_lib.StreamingCtrPipeline:
    """Pipe mode (``--pipe_mode 1``): one sequential single-pass stream over
    this rank's share of the files, the epochs replayed by the producer
    (the Pipe-mode FIFO shape); with fewer files than ranks each keeps
    every world-th record. One DataHealth is shared by the producer (read
    retries, per file) and the consumer (bad records)."""
    shard = _shard_spec(cfg, files)
    health = pipe_lib.DataHealth()
    stream = pipe_lib.ChainedFileStream(
        list(shard.files), num_epochs=epochs,
        shuffle_each_epoch=cfg.shuffle_files, seed=cfg.seed,
        epoch_offset=epoch_offset,
        retry_policy=retry_lib.policy_from_config(cfg), health=health)
    return pipe_lib.StreamingCtrPipeline(
        stream, field_size=cfg.field_size,
        batch_size=_local_batch_size(cfg),
        drop_remainder=cfg.drop_remainder,
        prefetch_batches=cfg.prefetch_batches,
        use_native_decoder=cfg.use_native_decoder,
        skip_batches=skip_batches, verify_crc=cfg.verify_crc,
        on_bad_record=cfg.on_bad_record,
        max_bad_records=cfg.max_bad_records, num_labels=cfg.num_tasks,
        health=health, record_shard=shard.record_shard)


# The online stream's high-water-mark sidecar, beside the checkpoints it
# stays consistent with.
_STREAM_SIDECAR = "stream_manifest.json"

# Files digest of online mode: the live listing grows by design, so the
# resume gate cannot fingerprint what will be read (the stream's sidecar
# says that); a constant keeps the gate from refusing a replayable skip.
_ONLINE_FILES_DIGEST = "online-stream-v1"


def make_online_pipeline(cfg: Config, train_dir: str, *, skip_batches: int = 0
                         ) -> Tuple[pipe_lib.StreamingCtrPipeline,
                                    stream_lib.UnboundedFileStream]:
    """``--online_mode``: the watcher tails ``tr*.tfrecords`` under
    ``train_dir`` (``data.stream``: admission, healing, the sidecar) and
    the streaming consumer decodes it. Returns (pipeline, stream): the
    stream handle lets the preemption path wake a blocked poll. One
    process only, as in the JAX package: ranks could record-shard an
    unbounded stream consistently only after a chief-coordinated
    admission order."""
    if bootstrap.process_count() > 1:
        raise NotImplementedError(
            "online_mode is single-process for now: shard admission order "
            "must be chief-coordinated before ranks can record-shard an "
            "unbounded stream consistently")
    health = pipe_lib.DataHealth()
    sidecar = (os.path.join(cfg.model_dir, _STREAM_SIDECAR)
               if cfg.model_dir else "")
    stream = stream_lib.UnboundedFileStream(
        train_dir, pattern="tr*.tfrecords", sidecar_path=sidecar,
        poll_secs=cfg.stream_poll_secs,
        idle_timeout_secs=cfg.stream_idle_timeout_secs,
        retry_policy=retry_lib.policy_from_config(cfg), health=health)
    pipeline = pipe_lib.StreamingCtrPipeline(
        stream, field_size=cfg.field_size, batch_size=cfg.batch_size,
        drop_remainder=cfg.drop_remainder,
        prefetch_batches=cfg.prefetch_batches,
        use_native_decoder=cfg.use_native_decoder,
        skip_batches=skip_batches, verify_crc=cfg.verify_crc,
        on_bad_record=cfg.on_bad_record,
        max_bad_records=cfg.max_bad_records, num_labels=cfg.num_tasks,
        stream_label=f"<online:{train_dir}>", health=health)
    return pipeline, stream


def _restore_or_init(trainer: Trainer, cfg: Config, require: bool,
                     mgr: Optional[ckpt_lib.CheckpointManager] = None
                     ) -> TrainState:
    """Fresh state, restored from the latest checkpoint when one exists.
    ``require`` (eval/infer/export) makes a missing checkpoint an error,
    checked before any directory is created. Under tiering the dense
    template is restored first, then adopted into the tier (the restored
    Adam slots seed the cold store)."""
    tier = trainer._tier
    state = trainer.init_state(tiered=False)

    def adopted(s: TrainState) -> TrainState:
        return tier.adopt(s) if tier is not None else s

    if not cfg.model_dir:
        if require:
            raise FileNotFoundError(
                f"task '{cfg.task_type}' requires model_dir")
        return adopted(state)
    if require and not os.path.isdir(cfg.model_dir):
        raise FileNotFoundError(
            f"task '{cfg.task_type}' needs a checkpoint in model_dir="
            f"{cfg.model_dir!r}")
    mgr = mgr or ckpt_lib.CheckpointManager(
        cfg.model_dir, max_to_keep=cfg.keep_checkpoint_max)
    if mgr.latest_step() is not None:
        return adopted(mgr.restore(state, shard=trainer.local_snapshot))
    if require:
        raise FileNotFoundError(
            f"task '{cfg.task_type}' needs a checkpoint in model_dir="
            f"{cfg.model_dir!r}")
    return adopted(state)


def _ckpt_state(trainer: Trainer, state: TrainState) -> TrainState:
    """What goes into every checkpoint: under tiering the densified state
    with full-shape Adam slots; under a model axis the gathered full state
    (a collective: every rank calls this); otherwise ``state`` itself."""
    tier = trainer._tier
    if tier is not None:
        return tier.checkpoint_state(state)
    return trainer.full_state(state)


def _servable_state(trainer: Trainer, state: TrainState) -> TrainState:
    """What the export serves: under tiering the full tables, not the hot
    window; under a model axis the gathered tables (every rank calls
    this)."""
    tier = trainer._tier
    if tier is not None:
        return tier.densified(state)
    return trainer.full_state(state)


def run(cfg: Config, device="cuda") -> Dict[str, float]:
    """Entry point: dispatch on ``cfg.task_type``; returns result metrics.
    ``device`` defaults to the card; pass ``"cpu"`` to run on the CPU. The
    process group comes up first under ``--dist_mode 1|2`` (a no-op when
    the launcher already started it)."""
    check_task_ported(cfg)
    bootstrap.initialize(cfg, device=device)
    # The --io_retry_* policy for every fileio op, and the read faults of
    # DEEPFM_TPU_READ_FAULT_EVERY (a drill's seam) when it is set.
    fileio.set_retry_policy(retry_lib.policy_from_config(cfg))
    faults_lib.install_env_faults()
    obs_dir = cfg.trace_dir or cfg.model_dir or "."
    obs_trace.configure(cfg.trace, capacity=cfg.trace_buffer,
                        trace_dir=obs_dir)
    snap_writer = None
    if cfg.metrics_snapshot_secs > 0:
        os.makedirs(obs_dir, exist_ok=True)
        snap_writer = obs_metrics.SnapshotWriter(
            os.path.join(obs_dir, f"metrics-{os.getpid()}.jsonl"),
            cfg.metrics_snapshot_secs)
    trainer = Trainer(cfg, device=device)
    log.info("task=%s model=%s device=%s processes=%d", cfg.task_type,
             cfg.model, trainer.device, bootstrap.process_count())
    tasks = {"train": _task_train, "eval": _task_eval, "infer": _task_infer,
             "export": _task_export}
    if cfg.task_type not in tasks:
        raise ValueError(f"unknown task_type {cfg.task_type!r}")
    try:
        return tasks[cfg.task_type](trainer, cfg)
    finally:
        if snap_writer is not None:
            snap_writer.close()
        obs_trace.export()


# ---------------------------------------------------------------------------
# Step-accurate resume: the data position beside each checkpoint
# ---------------------------------------------------------------------------

_RESUME_META = "resume_meta.json"


def _write_resume_meta(model_dir: str, meta: Dict) -> None:
    fileio.write_atomic(os.path.join(model_dir, _RESUME_META),
                        json.dumps(meta))


def _read_resume_meta(model_dir: str,
                      health: guard_lib.TrainHealth) -> Optional[Dict]:
    """The resume sidecar, or None. An unreadable one degrades to
    checkpoint-step-only resume (the interrupted epoch replays)."""
    path = os.path.join(model_dir, _RESUME_META)
    if not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (ValueError, OSError) as exc:
        log.warning("resume sidecar %s unreadable (%r); falling back to "
                    "checkpoint-step-only resume", path, exc)
        health.record_resume_meta_corrupt()
        return None


def _files_fingerprint(files: List[str], cfg: Optional[Config] = None
                       ) -> str:
    """Digest of what the pipeline would read (basenames + sizes): a
    mid-epoch skip is exact only over the same files. Computed on the
    chief. Under ``enable_data_multi_path`` (and the other shard-mapping
    flags) the digest also covers the mapping and EVERY local worker's
    training channel (each instance holds all of them), so an edit of a
    sibling's channel invalidates the skip; an unresolvable channel or a
    failed stat degrades to a stable marker."""
    h = hashlib.sha256(b"v1|")
    tagged = [("", p) for p in files]
    if cfg is not None and (cfg.enable_data_multi_path
                            or cfg.enable_s3_shard
                            or cfg.worker_per_host > 1):
        h.update(f"{int(cfg.enable_data_multi_path)}|"
                 f"{int(cfg.enable_s3_shard)}|{cfg.worker_per_host}|"
                 .encode())
        if cfg.enable_data_multi_path:
            tagged = []
            for r in range(_data_workers_per_host(cfg)):
                try:
                    chan_dir, _ = resolve_channel_dirs(cfg, process_index=r)
                    tagged.extend((f"c{r}", p)
                                  for p in resolve_files(chan_dir, "tr"))
                except (OSError, ValueError):
                    tagged.append((f"c{r}", "<unresolved>"))
    for tag, path in sorted(tagged):
        try:
            n = os.path.getsize(path) if path != "<unresolved>" else -2
        except OSError:
            n = -1
        name = f"{tag}={os.path.basename(path)}" if tag else \
            os.path.basename(path)
        h.update(f"{name}:{n}|".encode())
    return h.hexdigest()[:32]


def _consumption_layout(cfg: Config) -> List:
    """How batches are consumed: a mid-epoch skip is exact only when the
    resuming run emits and groups batches as the interrupted one did. The
    dispatch group size, the decode path (pooled native or per record), the
    decoded cache and the assembly route all change the pooled emission
    order, and online mode swaps the producer for the unbounded stream. ``grad_accum_steps`` does not change which batches a step count
    covers (``state.step`` counts microbatches), but it changes which
    optimizer trajectory wrote the checkpoint: a resume across any of these
    replays the epoch rather than skip along another stream. The number of
    processes (each reads its shard at ``batch_size / world`` rows) rides
    the tag of a multi-process run."""
    world = bootstrap.process_count()
    model = max(cfg.mesh_model, 1)
    tag = ("torch-2" if world == 1 else f"torch-2-w{world}" if model == 1
           else f"torch-2-w{world // model}x{model}")
    return [tag, cfg.steps_per_loop, int(cfg.use_native_decoder),
            cfg.batch_size, cfg.shuffle_buffer, cfg.seed,
            int(cfg.drop_remainder), int(cfg.shuffle_files),
            cache_lib.MODES.index(cfg.decoded_cache),
            int(cfg.native_assembly), int(cfg.online_mode),
            cfg.grad_accum_steps]


def _resume_position(cfg: Config, restored_step: int, files_digest: str,
                     health: guard_lib.TrainHealth) -> Tuple[int, int, int]:
    """(epoch_base, start_epoch, skip_batches) for this invocation.

    The sidecar applies only when its ``step`` is the restored checkpoint's
    (a sidecar ahead of every durable checkpoint is stale: it degrades to
    replaying the epoch). A completed prior invocation advances
    ``epoch_base`` so shuffle orders never repeat; an interrupted one of
    the same shape (pipe mode included) resumes mid-epoch, skipping the
    batches already trained."""
    meta = (_read_resume_meta(cfg.model_dir, health)
            if cfg.model_dir else None)
    if not meta or not restored_step:
        return 0, 0, 0
    base = int(meta.get("epoch_base", 0))
    # Epochs whose shuffle order the recorded invocation may have touched.
    # Pipe mode records epoch 0 (its position is steps into the stream)
    # while its producer may have replayed every epoch's order.
    touched = (int(meta.get("num_epochs", 0)) if meta.get("pipe_mode")
               else int(meta.get("epoch", 0)) + 1)
    if meta.get("step") != restored_step:
        # Stale: the position is unusable, the epoch base still advances.
        return base + touched, 0, 0
    if meta.get("completed"):
        return base + int(meta.get("num_epochs", 0)), 0, 0
    if (int(meta.get("num_epochs", -1)) == cfg.num_epochs
            and bool(meta.get("pipe_mode")) == bool(cfg.pipe_mode)
            and meta.get("layout") == _consumption_layout(cfg)
            and meta.get("files") == files_digest):
        return (base, int(meta.get("epoch", 0)),
                int(meta.get("steps_into_epoch", 0)))
    return base + touched, 0, 0


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------


def _export(trainer: Trainer, cfg: Config, state: TrainState
            ) -> Optional[str]:
    """The servable artifact of ``state``, written by the chief only
    (every rank takes part in gathering a sharded state's tables)."""
    full = _servable_state(trainer, state)
    if not bootstrap.is_chief():
        return None
    out = os.path.join(cfg.servable_model_dir, str(int(state.step)))
    model = trainer.servable_model(full)
    return export_lib.export_serving(model, cfg, out, step=int(state.step))


#: Fault-injection hooks of the train task, read from the environment:
#: stop with an error after N steps (after the checkpoint hook ran: a
#: deterministic crash for the resume path); pull the preemption trigger
#: after N steps (the graceful path: force-save, then exit 42); or write a
#: ``.preempt_hold`` sentinel into model_dir after N steps and wait there
#: (up to 120 s) for a real signal.
FAULT_AFTER_ENV = "DEEPFM_TPU_TORCH_FAULT_AFTER_STEPS"
PREEMPT_AFTER_ENV = "DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS"
PREEMPT_HOLD_ENV = "DEEPFM_TPU_TORCH_PREEMPT_HOLD_AFTER_STEPS"


def _env_steps(name: str) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else 0
    except ValueError:
        raise ValueError(
            f"{name} must be an integer step count, got {raw!r}") from None


def _maybe_poison(pipeline):
    """An armed NaN plan (``utils.faults.set_nan_plan``) wraps the pipeline
    once; the plan is consumed on pickup, so a rollback replay (or the next
    epoch) trains clean data."""
    plan = faults_lib.take_nan_plan()
    if plan is not None:
        return faults_lib.BatchPoisoner(pipeline, **plan)
    return pipeline


def _fit_epoch(trainer: Trainer, cfg: Config, state: TrainState, pipeline,
               hooks, guard, on_log=None
               ) -> Tuple[TrainState, Dict[str, float]]:
    """One epoch: device-resident when ``--device_dataset`` is set and the
    run qualifies, else the staged pipeline. A fallback warns with the
    reason, so a run expected on the device learns why it staged."""
    if cfg.device_dataset:
        reason = trainer.device_dataset_ineligible(pipeline)
        if reason is None:
            return trainer.fit_device_resident(state, pipeline, hooks=hooks,
                                               on_log=on_log, guard=guard)
        warnings.warn(
            f"--device_dataset fell back to the staged input path: {reason}",
            RuntimeWarning, stacklevel=2)
    return trainer.fit(state, pipeline, hooks=hooks, on_log=on_log,
                       guard=guard)


# Under more than one process the ranks consult their own clocks and flags
# only at agreed dispatch counts, then adopt one verdict: the eval (a
# collective) and the preemption save happen at the same dispatch on
# every rank without a sync per dispatch.
_EVAL_CHECK_DISPATCHES = 50


def _eval_check_due(n_dispatch: int) -> bool:
    """The rank-independent schedule of check dispatches: powers of two
    early, so short runs still get mid-train evals, then every
    ``_EVAL_CHECK_DISPATCHES``."""
    if n_dispatch < _EVAL_CHECK_DISPATCHES:
        return n_dispatch & (n_dispatch - 1) == 0  # 1, 2, 4, 8, 16, 32
    return n_dispatch % _EVAL_CHECK_DISPATCHES == 0


def _make_throttled_eval_hook(trainer: Trainer, cfg: Config,
                              va_files: List[str], result: Dict[str, float],
                              on_eval=None, evaluate=None):
    """Mid-train eval hook with TrainSpec/EvalSpec timing: the first eval
    no earlier than ``eval_start_delay_secs`` into the run, then at most
    one every ``eval_throttle_secs``, checked once per dispatch. Under
    more than one process the clock is read at the :func:`_eval_check_due`
    dispatches only and the chief's verdict is broadcast (``fit`` keeps
    the dispatch counts equal across ranks)."""
    t_start = time.time()
    last_eval_t: List[Optional[float]] = [None]
    n_dispatch = [0]
    result["mid_train_evals"] = 0.0

    def hook(state: TrainState, m) -> None:
        n_dispatch[0] += 1
        multi = bootstrap.process_count() > 1
        if multi and not _eval_check_due(n_dispatch[0]):
            return
        now = time.time()
        due = (now - t_start >= cfg.eval_start_delay_secs
               and (last_eval_t[0] is None
                    or now - last_eval_t[0] >= cfg.eval_throttle_secs))
        if multi:
            due = bool(bootstrap.broadcast_ints([int(due)])[0])
        if not due:
            return
        last_eval_t[0] = time.time()
        ev = (evaluate(state) if evaluate is not None
              else trainer.evaluate(state, _eval_pipeline(cfg, va_files)))
        result["mid_train_evals"] += 1
        result.update({"auc": ev["auc"], "eval_loss": ev["loss"],
                       "eval_examples_per_sec": ev["examples_per_sec"]})
        result.update({k: v for k, v in ev.items() if k.startswith("auc_")})
        log.info("throttled eval @ step %d: auc=%.5f loss=%.5f",
                 int(state.step), ev["auc"], ev["loss"])
        if on_eval is not None:
            on_eval(ev, state)

    return hook


def _make_online_eval(trainer: Trainer, cfg: Config, va_files: List[str],
                      window, step_fn):
    """Online-mode evaluate: one predict pass over the held-out files,
    folded into the sliding window (:class:`~.metrics.WindowedAuc`, or
    :class:`~.metrics.WindowedAucDict` with one window per task) at the
    current training step (``step_fn(state)``): "AUC over the last N steps
    of traffic" rather than the batch job's cumulative AUC. The loss is
    the task-weighted sum of the per-task clipped log losses."""
    task_names = cfg.task_names
    num_tasks = len(task_names)
    weights = cfg.task_weight_values

    def evaluate(state: TrainState) -> Dict[str, float]:
        pipeline = _eval_pipeline(cfg, va_files)
        probs: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        real_rows: List[int] = []
        t0 = time.time()

        def feed():
            for batch in pipeline:
                n = batch["label"].shape[0]
                real_rows.append(n)
                cols = [np.asarray(batch["label"]).reshape(-1)[:n]]
                if num_tasks > 1:
                    cols.append(np.asarray(batch["label2"]).reshape(-1)[:n])
                labels.append(np.stack(cols, axis=1))
                yield (pad_batch(batch, cfg.batch_size)
                       if n < cfg.batch_size else batch)

        for i, p in enumerate(trainer.predict(state, feed())):
            arr = np.asarray(p)
            if arr.ndim == 1:
                arr = arr[:, None]
            probs.append(arr[:real_rows[i]])
        elapsed = max(time.time() - t0, 1e-9)
        p = (np.concatenate(probs) if probs
             else np.zeros((0, num_tasks), np.float64)).astype(np.float64)
        y = (np.concatenate(labels) if labels
             else np.zeros((0, num_tasks), np.float64)).astype(np.float64)
        window.update(int(step_fn(state)), p, y)
        pc = np.clip(p, 1e-7, 1.0 - 1e-7)
        if len(y):
            per_task = -(y * np.log(pc) + (1.0 - y) * np.log1p(-pc)).mean(
                axis=0)
            loss = float(sum(w * per_task[t] for t, w in enumerate(weights)))
        else:
            loss = 0.0
        auc = window.compute()
        out = {"loss": loss, "examples_per_sec": len(y) / elapsed,
               "window_examples": float(window.examples)}
        if isinstance(auc, dict):
            out["auc"] = auc[task_names[0]]
            out.update({f"auc_{t}": v for t, v in auc.items()})
        else:
            out["auc"] = auc
        return out

    return evaluate


def _task_train(trainer: Trainer, cfg: Config) -> Dict[str, float]:
    train_dir, eval_dir = resolve_channel_dirs(cfg)
    tr_files = resolve_files(train_dir, "tr")
    va_files = resolve_files(eval_dir, "va")
    if not tr_files and not cfg.online_mode:
        # Online mode tails the directory: starting before the first shard
        # arrives is the normal case.
        raise FileNotFoundError(f"no training tfrecords in {train_dir!r}")
    _validate_shard_coverage(cfg, tr_files)
    log.info("train dir=%s files=%d eval files=%d", train_dir,
             len(tr_files), len(va_files))
    multi = bootstrap.process_count() > 1
    if cfg.clear_existing_model and cfg.model_dir:
        ckpt_lib.clear_model_dir(cfg.model_dir)  # the chief's rmtree
        # No rank builds its CheckpointManager (which re-creates the
        # directory) before the chief's delete is done.
        bootstrap.barrier()
    mgr = None
    if cfg.model_dir:
        mgr = ckpt_lib.CheckpointManager(
            cfg.model_dir, max_to_keep=cfg.keep_checkpoint_max,
            save_interval_steps=cfg.save_checkpoints_steps,
            max_save_failures=cfg.max_save_failures,
            retry_policy=retry_lib.policy_from_config(cfg))
    state = _restore_or_init(trainer, cfg, require=False, mgr=mgr)
    # One health record and one guard for the whole run (the skip/rollback
    # budget spans rollback attempts), and the process-wide preemption
    # listener: a flag set during start-up is honored at the first
    # dispatch.
    health = guard_lib.TrainHealth()
    guard = guard_lib.NonFiniteGuard.from_config(cfg, health=health)
    listener = preempt_lib.get_listener()
    # Online mode's listing grows by design: a stable digest keeps the
    # resume gate from refusing a replayable skip, and the stream's
    # high-water-mark sidecar says what will be read. The resume decision
    # is the chief's, broadcast (a rank deciding from its own view of the
    # files could desynchronize the lockstep).
    files_digest = ""
    if bootstrap.is_chief():
        files_digest = (_ONLINE_FILES_DIGEST if cfg.online_mode
                        else _files_fingerprint(tr_files, cfg))
    fault_after = _env_steps(FAULT_AFTER_ENV)
    preempt_after = _env_steps(PREEMPT_AFTER_ENV)
    hold_after = _env_steps(PREEMPT_HOLD_ENV)
    # train_and_evaluate timing: mid-train evals no earlier than
    # eval_start_delay_secs, then at most every eval_throttle_secs (and a
    # final one); with both 0, an eval after every epoch.
    eval_throttled = bool(va_files) and (
        cfg.eval_start_delay_secs > 0 or cfg.eval_throttle_secs > 0)
    result: Dict[str, float] = {}
    # Every pipeline (train and eval) owns a DataHealth; their counts fold
    # into one total for the run.
    health_totals: Dict[str, int] = {}

    def log_health(pipeline, where: str) -> None:
        data_health = getattr(pipeline, "health", None)
        if data_health is None:
            return
        if data_health.total_events:
            log.info("data health (%s): %s", where, data_health.summary())
        data_health.merge_into(health_totals)

    def run_eval(at_state: TrainState, where: str) -> Dict[str, float]:
        pipe = _eval_pipeline(cfg, va_files)
        ev = trainer.evaluate(at_state, pipe)
        log_health(pipe, where)
        return ev

    tb = TensorBoardWriter(cfg.tensorboard_dir if bootstrap.is_chief()
                           else "")

    def tb_log(step: int, loss: float, eps: float) -> None:
        tb.scalars(step, loss=loss, examples_per_sec=eps)

    def tb_eval(ev: Dict[str, float], at_state: TrainState) -> None:
        tb.scalars(int(at_state.step), eval_auc=ev["auc"],
                   eval_loss=ev["loss"])

    def record_eval(ev: Dict[str, float], at_state: TrainState) -> None:
        result.update({"auc": ev["auc"], "eval_loss": ev["loss"],
                       "eval_examples_per_sec": ev["examples_per_sec"]})
        # Named per-task AUCs beside the headline (multi-task runs).
        result.update({k: v for k, v in ev.items() if k.startswith("auc_")})
        if "window_examples" in ev:  # the online windowed AUC
            result["window_examples"] = ev["window_examples"]
        tb_eval(ev, at_state)

    def record_fit(fit_m: Dict[str, float]) -> None:
        if fit_m["steps"]:  # a fully skipped resumed epoch reports no loss
            result["loss"] = fit_m["loss"]
            result["examples_per_sec"] = fit_m.get("examples_per_sec", 0.0)
            result["step_ms_p50"] = fit_m.get("step_ms_p50", 0.0)
            result.update({k: v for k, v in fit_m.items()
                           if k.startswith(("hotcold_", "staging_",
                                            "collective_", "dispatch_",
                                            "exchange_"))})

    def attempt(state: TrainState) -> TrainState:
        """One training attempt from ``state``: the resume position, the
        hooks, the epochs (or the one stream) and the final save. A
        RollbackSignal ends the attempt; the loop below restores the latest
        checkpoint and starts another, whose resume position replays from
        that checkpoint's recorded offset."""
        restored_step = int(state.step)
        pos = (_resume_position(cfg, restored_step, files_digest, health)
               if bootstrap.is_chief() else (0, 0, 0))
        epoch_base, start_epoch, skip_batches = (
            bootstrap.broadcast_ints(pos) if multi else pos)
        if start_epoch or skip_batches:
            log.info("step-accurate resume: epoch %d (+%d batches already "
                     "trained), epoch_base=%d", start_epoch, skip_batches,
                     epoch_base)
        # Pipe mode's position is steps into the one stream (epoch 0).
        progress = {"epoch": start_epoch,
                    "epoch_start": restored_step - skip_batches}

        def meta(step: int, completed: bool) -> Dict:
            return {"step": step, "epoch": progress["epoch"],
                    "steps_into_epoch": step - progress["epoch_start"],
                    "epoch_base": epoch_base, "num_epochs": cfg.num_epochs,
                    "pipe_mode": int(cfg.pipe_mode),
                    "layout": _consumption_layout(cfg),
                    "files": files_digest, "completed": completed}

        def save(step: int, s: TrainState, *, completed: bool = False,
                 force: bool = False) -> bool:
            """A checkpoint and, once it is durable, its resume sidecar
            (an interval save lands on the executor thread; the sidecar's
            content is fixed now)."""
            m = meta(step, completed)
            return mgr.save(step, _ckpt_state(trainer, s), force=force,
                            on_saved=lambda: _write_resume_meta(
                                cfg.model_dir, m))

        # Hot publishing, per attempt: a rollback's replay starts with a
        # clean in-flight ledger (published versions stay, and a republish
        # of one is idempotent).
        publisher = None
        online_stream = [None]  # the UnboundedFileStream, for preemption
        if cfg.online_mode and (cfg.publish_every_steps
                                or cfg.publish_every_secs):
            pdir = cfg.publish_dir or (
                os.path.join(cfg.model_dir, "publish") if cfg.model_dir
                else "")
            if not pdir:
                raise ValueError("--publish_every_steps/secs needs "
                                 "--publish_dir or --model_dir")
            publisher = publish_lib.Publisher(
                cfg, pdir, every_steps=cfg.publish_every_steps,
                every_secs=cfg.publish_every_secs,
                timeout_s=cfg.publish_timeout_s, health=health)
            # A resumed run crosses the boundaries a fresh run would.
            publisher.seed_cadence(restored_step)
        drain_timeout = cfg.publish_timeout_s or None

        last_saved = [-1]
        hooks = []
        if publisher is not None:
            # Cadence, host snapshot, async submit; also the wedged-publish
            # watchdog (exit 43).
            hooks.append(lambda s, m: publisher.maybe_publish(s, s.step))

        if mgr is not None:
            def ckpt_hook(s: TrainState, m) -> None:
                if mgr.should_save(s.step) and save(s.step, s):
                    last_saved[0] = s.step
            hooks.append(ckpt_hook)

        if preempt_after:
            def trigger_hook(s: TrainState, m) -> None:
                if s.step - restored_step >= preempt_after:
                    listener.trigger(f"env trigger after "
                                     f"{s.step - restored_step} steps")
            hooks.append(trigger_hook)

        if hold_after:
            held = [False]

            def hold_hook(s: TrainState, m) -> None:
                if held[0] or s.step - restored_step < hold_after:
                    return
                held[0] = True
                sentinel = os.path.join(cfg.model_dir or ".",
                                        ".preempt_hold")
                with open(sentinel, "w", encoding="utf-8") as f:
                    f.write(str(s.step))
                deadline = time.time() + 120.0
                while not listener.triggered():
                    if time.time() > deadline:
                        raise RuntimeError(
                            "preempt hold: no signal arrived within 120s")
                    time.sleep(0.05)
            hooks.append(hold_hook)

        pc_dispatch = [0]

        def preempt_hook(s: TrainState, m) -> None:
            # Polled once per dispatch, after the dispatch's checkpoint
            # hook: the in-flight dispatch has finished. Under more than
            # one process the flag is read at the agreed dispatches only
            # and ORed over the ranks, so every rank saves and stops at
            # the same dispatch.
            pc_dispatch[0] += 1
            trig = listener.triggered()
            if multi:
                if not _eval_check_due(pc_dispatch[0]):
                    return
                trig = bootstrap.any_rank(trig)
            if not trig:
                return
            health.record_preemption()
            log.warning("preemption (%s): force-saving a checkpoint at step "
                        "%d, then exiting with code %d",
                        listener.reason or "peer rank", s.step,
                        preempt_lib.EXIT_PREEMPTED)
            if mgr is not None:
                # An interval save may have landed on this very step (save
                # dedups); the sidecar makes the mid-epoch resume exact.
                save(s.step, s, force=True)
                if bootstrap.is_chief():
                    _write_resume_meta(cfg.model_dir, meta(s.step, False))
            if online_stream[0] is not None:
                online_stream[0].request_stop()  # wake a blocked poll
            if publisher is not None:
                # A graceful preemption never abandons a half-staged
                # publish (a wedged one still trips exit 43).
                publisher.drain(timeout=drain_timeout)
            raise preempt_lib.Preempted(s.step, listener.reason)
        hooks.append(preempt_hook)

        if fault_after:
            def fault_hook(s: TrainState, m) -> None:
                if s.step - restored_step >= fault_after:
                    raise RuntimeError(
                        f"fault injection: simulated crash after "
                        f"{s.step - restored_step} steps")
            hooks.append(fault_hook)

        tracer = prof_lib.StepWindowTracer(
            cfg.profile_dir, num_steps=cfg.profile_steps,
            device=trainer.device)
        hooks.append(lambda s, m: tracer.on_step(int(m.get("steps_done", 1))))
        # Online windowed eval: the throttled eval decides when; this
        # evaluate swaps the cumulative AUC for the sliding window's.
        online_eval_fn = None
        if (cfg.online_mode and va_files
                and cfg.online_eval_window_steps > 0):
            if cfg.num_tasks > 1:
                window = metrics_lib.WindowedAucDict(
                    cfg.task_names, cfg.online_eval_window_steps,
                    num_bins=cfg.auc_num_thresholds)
            else:
                window = metrics_lib.WindowedAuc(
                    cfg.online_eval_window_steps,
                    num_bins=cfg.auc_num_thresholds)
            online_eval_fn = _make_online_eval(trainer, cfg, va_files,
                                               window, lambda s: s.step)
        final_eval = online_eval_fn or (lambda s: run_eval(s, "final eval"))
        if eval_throttled:
            hooks.append(_make_throttled_eval_hook(
                trainer, cfg, va_files, result, on_eval=tb_eval,
                evaluate=(online_eval_fn
                          or (lambda s: run_eval(s, "throttled eval")))))
        try:
            if cfg.pipe_mode:
                # One fit over one single-pass stream, the epochs replayed
                # by the producer (the Pipe-mode FIFO shape); a resume
                # skips the stream's trained prefix. Online mode swaps the
                # finite file chain for the directory watcher.
                if cfg.online_mode:
                    pipeline, ustream = make_online_pipeline(
                        cfg, train_dir, skip_batches=skip_batches)
                    online_stream[0] = ustream
                else:
                    pipeline = make_streaming_pipeline(
                        cfg, tr_files, epochs=cfg.num_epochs,
                        skip_batches=skip_batches, epoch_offset=epoch_base)
                pipeline = _maybe_poison(pipeline)
                state, fit_m = trainer.fit(state, pipeline, hooks=hooks,
                                           on_log=tb_log, guard=guard)
                log_health(pipeline, "stream end")
                if health.consume_dirty():
                    log.info("train health (stream end): %s",
                             health.summary())
                record_fit(fit_m)
                if publisher is not None:
                    # The stream ended (idle timeout or stop): one forced
                    # publish at the terminal step, so an interrupted and a
                    # clean run over the same shards share a final version.
                    publisher.drain(timeout=drain_timeout)
                    final_step = int(state.step)
                    if final_step and final_step not in publisher.published:
                        publisher.publish_now(state, final_step)
                        publisher.drain(timeout=drain_timeout)
                    pub_stats = publisher.stats()
                    result.update(pub_stats)
                    tb.scalar_dict(final_step, "publish/", pub_stats)
                if va_files:
                    ev = final_eval(state)
                    log.info("streaming train done: eval auc=%.5f loss=%.5f",
                             ev["auc"], ev["loss"])
                    record_eval(ev, state)
            else:
                for epoch in range(start_epoch, cfg.num_epochs):
                    progress["epoch"] = epoch
                    progress["epoch_start"] = state.step - (
                        skip_batches if epoch == start_epoch else 0)
                    pipeline = _maybe_poison(make_pipeline(
                        cfg, tr_files, epochs=1, shuffle=True,
                        epoch_offset=epoch_base + epoch,
                        skip_batches=(skip_batches if epoch == start_epoch
                                      else 0)))
                    state, fit_m = _fit_epoch(trainer, cfg, state, pipeline,
                                              hooks, guard, on_log=tb_log)
                    log_health(pipeline, f"epoch {epoch + 1} end")
                    if health.consume_dirty():
                        log.info("train health (epoch %d): %s", epoch + 1,
                                 health.summary())
                    record_fit(fit_m)
                    if (mgr is not None and last_saved[0] == state.step
                            and epoch + 1 < cfg.num_epochs):
                        # A checkpoint landed on this epoch's last step:
                        # point its sidecar at the next epoch instead of a
                        # fully trained one, once that checkpoint is
                        # durable.
                        progress["epoch"] = epoch + 1
                        progress["epoch_start"] = state.step
                        if (bootstrap.is_chief()
                                and state.step in mgr.all_steps()):
                            _write_resume_meta(cfg.model_dir,
                                               meta(state.step, False))
                    if va_files and not eval_throttled:
                        ev = run_eval(state, f"epoch {epoch + 1} eval")
                        log.info("epoch %d/%d: eval auc=%.5f loss=%.5f",
                                 epoch + 1, cfg.num_epochs, ev["auc"],
                                 ev["loss"])
                        record_eval(ev, state)
                if va_files and eval_throttled:
                    ev = final_eval(state)
                    log.info("final eval: auc=%.5f loss=%.5f", ev["auc"],
                             ev["loss"])
                    record_eval(ev, state)
        finally:
            tracer.close()
            if publisher is not None:
                publisher.close()
            if online_stream[0] is not None:
                online_stream[0].close()
                online_stream[0] = None
        if mgr is not None:
            save(state.step, state, completed=True, force=True)
            if bootstrap.is_chief():
                _write_resume_meta(cfg.model_dir, meta(state.step, True))
        return state

    try:
        while True:
            try:
                state = attempt(state)
                break
            except guard_lib.RollbackSignal as rs:
                # The guard's shared budget (max_rollbacks, over skips and
                # rollbacks) bounds how often a run gets here. The latest
                # step includes an interval save still landing (the
                # chief's; the others wait for it at the barrier).
                if mgr is not None:
                    mgr.wait()
                    bootstrap.barrier()
                if mgr is None or mgr.latest_step() is None:
                    raise guard_lib.NonFiniteError(
                        f"rollback requested at step {rs.step} but no "
                        f"checkpoint exists to roll back to (set model_dir "
                        f"or use on_nonfinite=skip)") from rs
                health.record_rollback()
                state = mgr.restore(trainer.init_state(),
                                    shard=trainer.local_snapshot)
                # The save cadence restarts from the restored checkpoint.
                mgr._last_should_save_step = None
                log.warning("rolled back: restored checkpoint step %d after "
                            "a non-finite value at step %d; replaying from "
                            "the recorded offset", state.step, rs.step)
        tb.scalars(int(state.step), **{f"health/{name}": float(v)
                                       for name, v in
                                       health.snapshot().items()})
    finally:
        tb.close()
        if mgr is not None:
            mgr.close()
    if cfg.servable_model_dir:
        _export(trainer, cfg, state)
    result["steps"] = float(state.step)
    result["read_retries"] = float(health_totals.get("read_retries", 0))
    result["bad_records"] = float(health_totals.get("bad_records", 0))
    if mgr is not None:
        result["save_failures"] = float(mgr.save_failures)
    result.update({k: float(v) for k, v in health.snapshot().items()})
    return result


def _task_eval(trainer: Trainer, cfg: Config) -> Dict[str, float]:
    _, eval_dir = resolve_channel_dirs(cfg)
    va_files = resolve_files(eval_dir, "va")
    if not va_files:
        raise FileNotFoundError("no eval tfrecords found")
    state = _restore_or_init(trainer, cfg, require=True)
    ev = trainer.evaluate(state, _eval_pipeline(cfg, va_files))
    log.info("eval: auc=%.5f loss=%.5f", ev["auc"], ev["loss"])
    return ev


def _interleave_rank_shards(gathered: np.ndarray, counts: np.ndarray
                            ) -> np.ndarray:
    """Global record order from per-rank record-sharded results: rank r
    held records r, r + world, r + 2 * world, ..., so global record
    ``i * world + r`` is ``gathered[r, i]``. Trailing dims (per-task
    columns) carry through."""
    world = gathered.shape[0]
    out = np.empty((int(counts.sum()),) + gathered.shape[2:],
                   dtype=gathered.dtype)
    for r in range(world):
        n = int(counts[r])
        out[r:(n - 1) * world + r + 1:world] = gathered[r, :n]
    return out


def _task_infer(trainer: Trainer, cfg: Config) -> Dict[str, float]:
    pred_dir = cfg.val_data_dir or cfg.data_dir
    te_files = resolve_files(pred_dir, "te")
    if not te_files:
        raise FileNotFoundError("no inference tfrecords found")
    state = _restore_or_init(trainer, cfg, require=True)
    procs = bootstrap.process_count()
    rank, world = _data_axis(cfg)
    local_bs = _local_batch_size(cfg)
    # Record-level shard: each data rank predicts every world-th record
    # (its model peers the same records) and the predictions of model
    # index 0 are re-interleaved into global order before the chief writes
    # them.
    files = tuple(sorted(te_files))
    pipeline = make_pipeline(cfg, list(files), shuffle=False,
                             drop_remainder=False, shard=shard_lib.ShardSpec(
                                 files, record_shard=((world, rank)
                                                      if world > 1 else None)))
    real_rows: List[int] = []

    def feed():
        if procs > 1:
            # Lockstep rounds, as eval's: every rank feeds the same number
            # of batches (an exhausted rank dummies, their output dropped).
            src = trainer.lockstep_batches(pipeline, lambda: zero_batch(
                cfg.field_size, local_bs, num_labels=cfg.num_tasks,
                hist_len=cfg.history_max_len))
        else:
            src = ((b, True) for b in pipeline)
        for batch, real in src:
            n = batch["label"].shape[0] if real else 0
            real_rows.append(n)
            yield (pad_batch(batch, local_bs) if real and n < local_bs
                   else batch)

    probs = [p[:real_rows[i]]
             for i, p in enumerate(trainer.predict(state, feed()))
             if real_rows[i]]
    # Single-task probabilities are [n]; multi-task [n, T], one column per
    # task in cfg.task_names order.
    tail = (cfg.num_tasks,) if cfg.num_tasks > 1 else ()
    local = (np.concatenate(probs) if probs
             else np.zeros((0,) + tail, np.float32)).astype(np.float32)
    if procs > 1:
        gathered, counts = bootstrap.allgather_rows(local)
        col0 = slice(None, None, procs // world)  # model index 0 of each row
        all_probs = _interleave_rank_shards(gathered[col0], counts[col0])
    else:
        all_probs = local
    out_path = os.path.join(pred_dir, "pred.txt")
    if bootstrap.is_chief():
        with open(out_path, "w", encoding="utf-8") as f:
            # One line per record; a multi-task model writes one
            # space-separated column per task.
            for p in all_probs:
                f.write(" ".join(f"{float(v):.6f}" for v in np.atleast_1d(p))
                        + "\n")
        log.info("wrote %d predictions to %s", len(all_probs), out_path)
    return {"num_predictions": float(len(all_probs))}


def _task_export(trainer: Trainer, cfg: Config) -> Dict[str, float]:
    if not cfg.servable_model_dir:
        raise ValueError("export task requires servable_model_dir")
    state = _restore_or_init(trainer, cfg, require=True)
    _export(trainer, cfg, state)
    return {"step": float(state.step)}
