"""Checkpoint and resume on a local ``model_dir`` (the port's counterpart of
``deepfm_tpu.utils.checkpoint``, which wraps Orbax).

One file per checkpoint, ``ckpt-<step>.pt``: the :class:`TrainState`
snapshot (``TrainState.to_dict``) written with ``torch.save`` to a private
temporary file and renamed into place, so a reader sees a whole checkpoint
or none. ``max_to_keep`` newest checkpoints are kept. Orbax checkpoints of
the JAX package do not load here: weights carry over as numpy
(``utils.params``).

Saves are asynchronous by default, as Orbax's are. A save first takes a
completed host copy of the state on the caller's thread (the steps update
the state in place, so the copy must finish before the next dispatch);
the ``torch.save``, the rename and the pruning then run on the
:class:`AsyncSaveExecutor`'s thread. A forced save (end of run,
preemption, a rollback's target) waits for the saves in flight and writes
synchronously, and every read (``all_steps``, ``latest_step``,
``restore``) first waits for this manager's saves in flight. ``on_saved``
callbacks (the resume sidecar) run only once their checkpoint is durable. An interval save that fails is logged and
deferred to the next interval; only more than ``max_save_failures``
consecutive failures abort the run, and a forced save that fails always
raises. ``latest_step`` and ``restore`` read through ``retry_policy``.

Under data parallelism only the chief writes (saves, async saves and
``clear_model_dir``); every rank holds the same replicated state and
restores the same checkpoint from the shared ``model_dir``. Under a model
axis the caller hands :meth:`CheckpointManager.save` the gathered full
state (``Trainer.full_state``) and :meth:`CheckpointManager.restore` a
``shard`` function that cuts the full arrays to the rank's rows
(``Trainer.local_snapshot``): a checkpoint's arrays never depend on the
mesh.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..parallel import bootstrap
from . import retry as retry_lib

log = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.pt$")


class AsyncSaveExecutor:
    """One background thread for artifact writes off the training hot path
    (interval checkpoints, the publisher's exports): writes never compete
    with each other, and :meth:`drain` gives the preemption path one place
    to wait. The thread starts at the first submit."""

    def __init__(self, name: str = "async-save"):
        self._name = name
        self._lock = threading.Lock()
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None

    def submit(self, fn: Callable, *args, **kwargs
               ) -> concurrent.futures.Future:
        with self._lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=self._name)
            return self._pool.submit(fn, *args, **kwargs)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for every submitted job; True iff all finished in time. A
        no-op job behind them rides the single thread's FIFO order."""
        with self._lock:
            pool = self._pool
        if pool is None:
            return True
        fence = pool.submit(lambda: None)
        try:
            fence.result(timeout=timeout)
            return True
        except concurrent.futures.TimeoutError:
            return False

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 0, async_save: bool = True,
                 max_save_failures: int = 3,
                 retry_policy: Optional[retry_lib.RetryPolicy] = None):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max(int(max_to_keep), 1)
        self.save_interval_steps = save_interval_steps
        self._last_should_save_step: Optional[int] = None
        self.async_save = bool(async_save)
        # Interval saves that fail are deferred; more than this many in a
        # row abort (0: the first failure aborts).
        self.max_save_failures = int(max_save_failures)
        self.save_failures = 0
        self._consecutive_failures = 0
        self._retry = retry_policy
        self._executor = AsyncSaveExecutor(name="ckpt-save")
        # Steps saved or being saved by this manager (dedup of a forced save
        # landing on an interval save's step).
        self._saved_steps: set = set()
        self._inflight: List[Tuple[int, concurrent.futures.Future]] = []
        self._lock = threading.Lock()

    @property
    def directory(self) -> str:
        return self._dir

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt-{int(step)}.pt")

    def _read(self, fn: Callable, op_name: str):
        if self._retry is None:
            return fn()
        return self._retry.call(fn, op_name=op_name)

    def _listing(self) -> List[int]:
        def listing() -> List[int]:
            steps = []
            for name in os.listdir(self._dir):
                m = _CKPT_RE.match(name)
                if m:
                    steps.append(int(m.group(1)))
            return sorted(steps)
        return self._read(listing, f"all_steps({self._dir})")

    def all_steps(self) -> List[int]:
        """Durable checkpoints, this manager's saves in flight included
        (read-your-writes: it waits for them to land)."""
        self.wait()
        return self._listing()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- saving --------------------------------------------------------
    def _do_save(self, step: int, snapshot: Dict[str, Any]) -> None:
        """Write one host snapshot: temp file, fsync, rename, prune. The
        seam a test patches to inject a failing write."""
        fd, tmp = tempfile.mkstemp(dir=self._dir, prefix=".tmp-ckpt-")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(snapshot, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        for old in self._listing()[:-self.max_to_keep]:
            os.remove(self._path(old))
        log.info("checkpoint saved at step %d -> %s", step, self._dir)

    def _write(self, step: int, snapshot: Dict[str, Any],
               on_saved: Optional[Callable[[], None]]) -> None:
        self._do_save(step, snapshot)
        if on_saved is not None:
            on_saved()

    def _failed(self, step: int, exc: BaseException) -> None:
        """Account one failed interval save: defer it, or abort past the
        consecutive-failure budget."""
        self._saved_steps.discard(step)
        self.save_failures += 1
        self._consecutive_failures += 1
        if self._consecutive_failures > self.max_save_failures:
            raise IOError(
                f"checkpoint save failed {self._consecutive_failures} "
                f"consecutive times (max_save_failures="
                f"{self.max_save_failures}) at step {step}: {exc}") from exc
        log.warning("checkpoint save at step %d failed (%d consecutive, "
                    "tolerating %d); deferring to the next interval: %s",
                    step, self._consecutive_failures, self.max_save_failures,
                    exc)

    def _reap(self, block: bool) -> None:
        """Collect finished (with ``block``, all) async saves, in the order
        they were submitted, into the failure accounting."""
        while True:
            with self._lock:
                if not self._inflight:
                    return
                step, fut = self._inflight[0]
                if not block and not fut.done():
                    return
                self._inflight.pop(0)
            try:
                fut.result()
            except Exception as exc:  # noqa: BLE001 (accounted here)
                self._failed(step, exc)
            else:
                self._consecutive_failures = 0

    def save(self, step: int, state, *, force: bool = False,
             on_saved: Optional[Callable[[], None]] = None) -> bool:
        """Save ``state`` at ``step``; False when that step is already saved
        (or being saved) or an interval save failed within its budget.
        ``on_saved`` runs once the checkpoint is durable."""
        step = int(step)
        if not bootstrap.is_chief():
            # The chief writes the replicated state; this rank keeps only
            # the dedup bookkeeping, so its answers match the chief's.
            if step in self._saved_steps:
                return False
            self._saved_steps.add(step)
            return True
        if force:
            self.wait()
        else:
            self._reap(block=False)
        if step in self._saved_steps or step in self._listing():
            return False
        snapshot = state.to_dict()  # a completed host copy, this thread
        self._saved_steps.add(step)
        if force or not self.async_save:
            try:
                self._write(step, snapshot, on_saved)
            except Exception as exc:
                if force:
                    self._saved_steps.discard(step)
                    self.save_failures += 1
                    raise
                self._failed(step, exc)
                return False
            self._consecutive_failures = 0
            return True
        fut = self._executor.submit(self._write, step, snapshot, on_saved)
        with self._lock:
            self._inflight.append((step, fut))
        return True

    def wait(self) -> None:
        """Block until every save in flight has landed (or failed, which is
        accounted as an interval-save failure)."""
        self._reap(block=True)

    def close(self) -> None:
        self.wait()
        self._executor.close()

    def restore(self, template, step: Optional[int] = None, *,
                shard: Optional[Callable[[Dict[str, Any]],
                                         Dict[str, Any]]] = None):
        """Load a checkpoint (default: the latest) into ``template``'s
        tensors, in place, on their devices; returns the template.
        ``shard`` maps the loaded snapshot to the template's layout first
        (a row-sharded state's rows)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        d = self._read(lambda: torch.load(self._path(step),
                                          map_location="cpu",
                                          weights_only=True),
                       f"restore(step {step}, {self._dir})")
        template.load_dict(d if shard is None else shard(d))
        log.info("restored checkpoint step %d from %s", step, self._dir)
        return template

    def should_save(self, step: int) -> bool:
        """True when ``step`` crosses a save-interval boundary since the last
        query (steps may advance by more than one per call). Seeded from
        the latest checkpoint, so a resumed run saves on schedule."""
        if not self.save_interval_steps:
            return False
        if self._last_should_save_step is None:
            self._last_should_save_step = self.latest_step() or 0
        crossed = (step // self.save_interval_steps
                   > self._last_should_save_step // self.save_interval_steps)
        self._last_should_save_step = step
        return crossed


def clear_model_dir(directory: str) -> None:
    """``clear_existing_model``: wipe the checkpoint dir for a fresh run;
    chief only (the caller puts the other ranks behind a barrier)."""
    if not bootstrap.is_chief():
        return
    if os.path.isdir(directory):
        shutil.rmtree(directory)
        log.info("cleared existing model dir %s", directory)
