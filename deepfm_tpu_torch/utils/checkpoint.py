"""Checkpoint and resume on a local ``model_dir`` (the port's counterpart of
``deepfm_tpu.utils.checkpoint``, which wraps Orbax).

One file per checkpoint, ``ckpt-<step>.pt``: the :class:`TrainState`
snapshot (``TrainState.to_dict``) written with ``torch.save`` to a private
temporary file and renamed into place, so a reader sees a whole checkpoint
or none. ``max_to_keep`` newest checkpoints are kept. Saves are
synchronous; the JAX package's async saving is not ported yet. Orbax
checkpoints of the JAX package do not load here: weights carry over as
numpy (``utils.params``).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import tempfile
from typing import List, Optional

import torch

log = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 0):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max(int(max_to_keep), 1)
        self.save_interval_steps = save_interval_steps
        self._last_should_save_step: Optional[int] = None

    @property
    def directory(self) -> str:
        return self._dir

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt-{int(step)}.pt")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self._dir):
            m = _CKPT_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> bool:
        """Write the checkpoint of ``state`` at ``step``; False when that
        step is already saved."""
        if step in self.all_steps():
            return False
        fd, tmp = tempfile.mkstemp(dir=self._dir, prefix=".tmp-ckpt-")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(state.to_dict(), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        log.info("checkpoint saved at step %d -> %s", step, self._dir)
        return True

    def restore(self, template, step: Optional[int] = None):
        """Load a checkpoint (default: the latest) into ``template``'s
        tensors, in place, on their devices; returns the template."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        d = torch.load(self._path(step), map_location="cpu",
                       weights_only=True)
        template.load_dict(d)
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
    """``clear_existing_model``: wipe the checkpoint dir for a fresh run."""
    if os.path.isdir(directory):
        shutil.rmtree(directory)
        log.info("cleared existing model dir %s", directory)
