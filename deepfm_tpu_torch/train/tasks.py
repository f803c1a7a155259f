"""Tasks: train / eval / infer / export on one device (port of the
single-process path of ``deepfm_tpu.train.tasks``).

  * ``train`` — per-epoch train loop with an eval after each epoch, a
    checkpoint every ``save_checkpoints_steps`` and at the end, resume from
    the latest checkpoint in ``model_dir`` (mid-epoch exact through the
    ``resume_meta.json`` sidecar), ``clear_existing_model``, and a final
    serving export when ``servable_model_dir`` is set.
  * ``eval`` — AUC + loss on the eval files.
  * ``infer`` — one probability per line to ``pred.txt``.
  * ``export`` — the servable artifact of the latest checkpoint, through
    ``utils.export.export_serving``: what ``serve.ServingEngine`` loads.

Files resolve as in the JAX package: ``tr*`` / ``va*`` / ``te*`` +
``.tfrecords``, falling back to every ``*.tfrecords`` in the directory.

``run(cfg, device="cuda")`` runs on the card unless the caller asks for
the CPU. Modes the port has not reached raise ``NotImplementedError``
naming their flag (see ``check_task_ported``).
"""

from __future__ import annotations

import glob as _glob
import hashlib
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..data import pipeline as pipe_lib
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..utils import checkpoint as ckpt_lib
from ..utils import export as export_lib
from . import guard as guard_lib
from .loop import Trainer, check_ported, pad_batch
from .state import TrainState

log = logging.getLogger(__name__)


def check_task_ported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a task mode the port has not
    reached yet, naming its flag."""
    check_ported(cfg)
    unported = [
        (cfg.online_mode, "--online_mode (the online trainer)"),
        (cfg.pipe_mode, "--pipe_mode (the streaming pipeline)"),
        (cfg.publish_every_steps or cfg.publish_every_secs or cfg.publish_dir,
         "--publish_every_steps/--publish_every_secs/--publish_dir "
         "(online publishing)"),
        (cfg.tensorboard_dir, "--tensorboard_dir (TensorBoard summaries)"),
        (cfg.profile_dir, "--profile_dir (the profiler trace window)"),
        (cfg.eval_start_delay_secs > 0 or cfg.eval_throttle_secs > 0,
         "--eval_start_delay_secs/--eval_throttle_secs (throttled eval)"),
        (cfg.decoded_cache != "off", "--decoded_cache (the decoded cache)"),
        (cfg.input_workers > 0, "--input_workers (the input service)"),
        (cfg.on_bad_record != "raise",
         f"--on_bad_record {cfg.on_bad_record} (bad-record skipping)"),
        (cfg.enable_data_multi_path,
         "--enable_data_multi_path (multi-path channels)"),
        (cfg.num_processes > 1, "--num_processes > 1 (multi-process runs)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not yet ported to deepfm_tpu_torch")


def resolve_files(directory: str, prefix: str) -> List[str]:
    """Glob ``{prefix}*.tfrecords``; fall back to all ``*.tfrecords``."""
    if not directory:
        return []
    files = _glob.glob(os.path.join(directory, f"{prefix}*.tfrecords"))
    if not files:
        files = _glob.glob(os.path.join(directory, "*.tfrecords"))
    return sorted(files)


def resolve_channel_dirs(cfg: Config) -> Tuple[str, str]:
    """(train_dir, eval_dir). With SageMaker-style channels (eval channel
    first) each resolves to ``$SM_CHANNEL_<NAME>``, else a
    ``<data_dir>/<name>`` subdirectory, else ``data_dir``."""
    names = cfg.channel_names
    eval_default = cfg.val_data_dir or cfg.data_dir
    if not names:
        return cfg.data_dir, eval_default

    def path(name: str) -> str:
        env_key = "SM_CHANNEL_" + "".join(
            c if c.isalnum() else "_" for c in name).upper()
        if os.environ.get(env_key):
            return os.environ[env_key]
        sub = os.path.join(cfg.data_dir, name) if cfg.data_dir else ""
        return sub if sub and os.path.isdir(sub) else cfg.data_dir

    eval_dir = path(names[0]) if len(names) > 1 else eval_default
    train_names = names[1:] if len(names) > 1 else names
    return path(train_names[0]), eval_dir


def make_pipeline(cfg: Config, files: List[str], *, epochs: int = 1,
                  shuffle: bool = True, drop_remainder: Optional[bool] = None,
                  epoch_offset: int = 0,
                  skip_batches: int = 0) -> pipe_lib.CtrPipeline:
    return pipe_lib.CtrPipeline(
        sorted(files), field_size=cfg.field_size, batch_size=cfg.batch_size,
        num_epochs=epochs, shuffle=shuffle,
        shuffle_files=shuffle and cfg.shuffle_files,
        shuffle_buffer=cfg.shuffle_buffer,
        drop_remainder=(cfg.drop_remainder if drop_remainder is None
                        else drop_remainder),
        seed=cfg.seed, prefetch_batches=cfg.prefetch_batches,
        use_native_decoder=cfg.use_native_decoder,
        verify_crc=cfg.verify_crc, epoch_offset=epoch_offset,
        skip_batches=skip_batches)


def _eval_pipeline(cfg: Config, va_files: List[str]) -> pipe_lib.CtrPipeline:
    """Eval reads every record: no shuffle, keep the tail batch (the eval
    step pads it with zero-weight rows)."""
    return make_pipeline(cfg, va_files, shuffle=False, drop_remainder=False)


def _restore_or_init(trainer: Trainer, cfg: Config, require: bool,
                     mgr: Optional[ckpt_lib.CheckpointManager] = None
                     ) -> TrainState:
    """Fresh state, restored from the latest checkpoint when one exists.
    ``require`` (eval/infer/export) makes a missing checkpoint an error,
    checked before any directory is created."""
    state = trainer.init_state()
    if not cfg.model_dir:
        if require:
            raise FileNotFoundError(
                f"task '{cfg.task_type}' requires model_dir")
        return state
    if require and not os.path.isdir(cfg.model_dir):
        raise FileNotFoundError(
            f"task '{cfg.task_type}' needs a checkpoint in model_dir="
            f"{cfg.model_dir!r}")
    mgr = mgr or ckpt_lib.CheckpointManager(
        cfg.model_dir, max_to_keep=cfg.keep_checkpoint_max)
    if mgr.latest_step() is not None:
        return mgr.restore(state)
    if require:
        raise FileNotFoundError(
            f"task '{cfg.task_type}' needs a checkpoint in model_dir="
            f"{cfg.model_dir!r}")
    return state


def run(cfg: Config, device="cuda") -> Dict[str, float]:
    """Entry point: dispatch on ``cfg.task_type``; returns result metrics.
    ``device`` defaults to the card; pass ``"cpu"`` to run on the CPU."""
    check_task_ported(cfg)
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
    log.info("task=%s model=%s device=%s", cfg.task_type, cfg.model,
             trainer.device)
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
    export_lib.write_atomic(os.path.join(model_dir, _RESUME_META),
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


def _files_fingerprint(files: List[str]) -> str:
    """Digest of what the pipeline would read (basenames + sizes): a
    mid-epoch skip is exact only over the same files."""
    h = hashlib.sha256(b"v1|")
    for path in sorted(files):
        h.update(f"{os.path.basename(path)}:{os.path.getsize(path)}|"
                 .encode())
    return h.hexdigest()[:32]


def _consumption_layout(cfg: Config) -> List:
    """How batches are consumed: a mid-epoch skip is exact only when the
    resuming run batches and shuffles as the interrupted one did."""
    return ["torch-1", cfg.batch_size, cfg.shuffle_buffer, cfg.seed,
            int(cfg.drop_remainder), int(cfg.shuffle_files)]


def _resume_position(cfg: Config, restored_step: int, files_digest: str,
                     health: guard_lib.TrainHealth) -> Tuple[int, int, int]:
    """(epoch_base, start_epoch, skip_batches) for this invocation.

    The sidecar applies only when its ``step`` is the restored checkpoint's.
    A completed prior invocation advances ``epoch_base`` so shuffle orders
    never repeat; an interrupted one of the same shape resumes mid-epoch,
    skipping the batches already trained."""
    meta = (_read_resume_meta(cfg.model_dir, health)
            if cfg.model_dir else None)
    if not meta or not restored_step:
        return 0, 0, 0
    base = int(meta.get("epoch_base", 0))
    touched = int(meta.get("epoch", 0)) + 1
    if meta.get("step") != restored_step:
        return base + touched, 0, 0
    if meta.get("completed"):
        return base + int(meta.get("num_epochs", 0)), 0, 0
    if (int(meta.get("num_epochs", -1)) == cfg.num_epochs
            and meta.get("layout") == _consumption_layout(cfg)
            and meta.get("files") == files_digest):
        return (base, int(meta.get("epoch", 0)),
                int(meta.get("steps_into_epoch", 0)))
    return base + touched, 0, 0


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------


def _export(trainer: Trainer, cfg: Config, state: TrainState) -> str:
    out = os.path.join(cfg.servable_model_dir, str(int(state.step)))
    return export_lib.export_serving(trainer.servable_model(state), cfg, out,
                                     step=int(state.step))


def _task_train(trainer: Trainer, cfg: Config) -> Dict[str, float]:
    train_dir, eval_dir = resolve_channel_dirs(cfg)
    tr_files = resolve_files(train_dir, "tr")
    va_files = resolve_files(eval_dir, "va")
    if not tr_files:
        raise FileNotFoundError(f"no training tfrecords in {train_dir!r}")
    log.info("train dir=%s files=%d eval files=%d", train_dir,
             len(tr_files), len(va_files))
    if cfg.clear_existing_model and cfg.model_dir:
        ckpt_lib.clear_model_dir(cfg.model_dir)
    mgr = None
    if cfg.model_dir:
        mgr = ckpt_lib.CheckpointManager(
            cfg.model_dir, max_to_keep=cfg.keep_checkpoint_max,
            save_interval_steps=cfg.save_checkpoints_steps)
    state = _restore_or_init(trainer, cfg, require=False, mgr=mgr)
    health = guard_lib.TrainHealth()
    guard = guard_lib.NonFiniteGuard.from_config(cfg, health=health)

    restored_step = int(state.step)
    files_digest = _files_fingerprint(tr_files)
    epoch_base, start_epoch, skip_batches = _resume_position(
        cfg, restored_step, files_digest, health)
    if start_epoch or skip_batches:
        log.info("step-accurate resume: epoch %d (+%d batches already "
                 "trained), epoch_base=%d", start_epoch, skip_batches,
                 epoch_base)
    progress = {"epoch": start_epoch,
                "epoch_start": restored_step - skip_batches}

    def meta(step: int, completed: bool) -> Dict:
        return {"step": step, "epoch": progress["epoch"],
                "steps_into_epoch": step - progress["epoch_start"],
                "epoch_base": epoch_base, "num_epochs": cfg.num_epochs,
                "layout": _consumption_layout(cfg), "files": files_digest,
                "completed": completed}

    last_saved = [-1]
    hooks = []
    if mgr is not None:
        def ckpt_hook(s: TrainState, m) -> None:
            if mgr.should_save(s.step) and mgr.save(s.step, s):
                last_saved[0] = s.step
                _write_resume_meta(cfg.model_dir, meta(s.step, False))
        hooks.append(ckpt_hook)

    result: Dict[str, float] = {}
    for epoch in range(start_epoch, cfg.num_epochs):
        progress["epoch"] = epoch
        progress["epoch_start"] = state.step - (
            skip_batches if epoch == start_epoch else 0)
        pipeline = make_pipeline(
            cfg, tr_files, epochs=1, shuffle=True,
            epoch_offset=epoch_base + epoch,
            skip_batches=skip_batches if epoch == start_epoch else 0)
        state, fit_m = trainer.fit(state, pipeline, hooks=hooks, guard=guard)
        if fit_m["steps"]:
            result["loss"] = fit_m["loss"]
            result["examples_per_sec"] = fit_m.get("examples_per_sec", 0.0)
            result["step_ms_p50"] = fit_m.get("step_ms_p50", 0.0)
        if (mgr is not None and last_saved[0] == state.step
                and epoch + 1 < cfg.num_epochs):
            # A checkpoint landed on this epoch's last step: point the
            # sidecar at the next epoch instead of a fully trained one.
            progress["epoch"] = epoch + 1
            progress["epoch_start"] = state.step
            _write_resume_meta(cfg.model_dir, meta(state.step, False))
        if va_files:
            ev = trainer.evaluate(state, _eval_pipeline(cfg, va_files))
            log.info("epoch %d/%d: eval auc=%.5f loss=%.5f", epoch + 1,
                     cfg.num_epochs, ev["auc"], ev["loss"])
            result.update({"auc": ev["auc"], "eval_loss": ev["loss"],
                           "eval_examples_per_sec": ev["examples_per_sec"]})
    if mgr is not None:
        mgr.save(state.step, state)
        _write_resume_meta(cfg.model_dir, meta(state.step, True))
    if cfg.servable_model_dir:
        _export(trainer, cfg, state)
    result["steps"] = float(state.step)
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


def _task_infer(trainer: Trainer, cfg: Config) -> Dict[str, float]:
    pred_dir = cfg.val_data_dir or cfg.data_dir
    te_files = resolve_files(pred_dir, "te")
    if not te_files:
        raise FileNotFoundError("no inference tfrecords found")
    state = _restore_or_init(trainer, cfg, require=True)
    pipeline = make_pipeline(cfg, te_files, shuffle=False,
                             drop_remainder=False)
    real_rows: List[int] = []

    def feed():
        for batch in pipeline:
            n = batch["label"].shape[0]
            real_rows.append(n)
            yield pad_batch(batch, cfg.batch_size) if n < cfg.batch_size \
                else batch

    probs = [p[:real_rows[i]]
             for i, p in enumerate(trainer.predict(state, feed()))]
    all_probs = (np.concatenate(probs) if probs
                 else np.zeros((0,), np.float32)).astype(np.float32)
    out_path = os.path.join(pred_dir, "pred.txt")
    with open(out_path, "w", encoding="utf-8") as f:
        for p in all_probs:
            f.write(f"{float(p):.6f}\n")
    log.info("wrote %d predictions to %s", len(all_probs), out_path)
    return {"num_predictions": float(len(all_probs))}


def _task_export(trainer: Trainer, cfg: Config) -> Dict[str, float]:
    if not cfg.servable_model_dir:
        raise ValueError("export task requires servable_model_dir")
    state = _restore_or_init(trainer, cfg, require=True)
    _export(trainer, cfg, state)
    return {"step": float(state.step)}
