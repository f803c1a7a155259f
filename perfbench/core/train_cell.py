"""One run of a training cell: set-up, the checked first steps, the timed
or traced window, and the comparison with the plain reference.

The window drives ``Trainer.fit_device_resident`` over a feed of columns
made from the seed (:class:`ResidentFeed`, the pipe contract that
``train/tasks.py`` hands it), on one card. What depends on the model (the
rows, the weights, the step shapes, the first-gradient read and the
reference) is the family's (``perfbench/families/``), found by the
configuration's ``flags["model"]``.

Set-up builds one trainer and one state, loads the benchmark's weights
into it, and drives it through the first ``checked_steps`` steps with the
window's own call and feed; the window then goes on from that state. The
reference follows those first steps from the same weights and rows once
the window has closed, the peak memory has been read and the program's
state is freed.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from ..gen import traffic as gen
from . import device_trace
from . import registry


def program_config(cell: Dict, seed: int):
    """The program's ``Config``: the configuration's flags, the traffic's
    batch and dispatch depth, and the resident feed's settings."""
    from deepfm_tpu_torch.config import Config  # noqa: PLC0415
    t = cell["traffic"]
    flags = dict(cell["config"]["flags"])
    flags.update(batch_size=t["batch_per_card"],
                 steps_per_loop=t["steps_per_loop"],
                 seed=seed % (2**31 - 1), num_epochs=1,
                 device_dataset=True, decoded_cache="ram")
    return Config(**flags)


class ResidentFeed:
    """The pipe contract of ``Trainer.fit_device_resident`` over columns
    made from the seed: one decoded epoch, whose rows the calls walk
    through in a few permutations drawn from the seed at set-up. Each
    call is one epoch of the program's loop; :meth:`advance` hands it the
    next ``steps`` batches of rows, starting the next permutation where
    the current one has fewer left."""

    def __init__(self, cols, batch_size: int, orders: List[np.ndarray],
                 fingerprint: str):
        self._cols = cols
        self._orders = orders
        self._fp = fingerprint
        self._order, self._offset = 0, 0
        self._next = orders[0][:0]
        self.batch_size = batch_size
        self.num_epochs = 1
        self.epoch_offset = 0
        self.drop_remainder = True
        self.shuffle = True
        # The pool covers the epoch: the order is the feed's own.
        self.shuffle_buffer = cols.num_records + 1
        self.decoded_cache = "ram"
        self.skip_batches = 0
        self.health = None

    def advance(self, steps: int) -> None:
        need = steps * self.batch_size
        if need > len(self._orders[0]):
            raise ValueError(f"{steps} steps need more rows than an epoch")
        if self._offset + need > len(self._orders[self._order]):
            self._order = (self._order + 1) % len(self._orders)
            self._offset = 0
        self._next = self._orders[self._order][self._offset:
                                               self._offset + need]
        self._offset += need

    def decoded_epoch_columns(self):
        return self._cols

    def decoded_cache_fingerprint(self) -> str:
        return self._fp

    def device_epoch_indices(self, epoch: int, k: int = 1) -> np.ndarray:
        return self._next


def host_columns(cols: Dict[str, torch.Tensor]):
    from deepfm_tpu_torch.data.cache import CacheColumns  # noqa: PLC0415
    n = int(cols["label"].shape[0])
    return CacheColumns(cols["label"].cpu().numpy(), cols["ids"].cpu().numpy(),
                        cols["vals"].cpu().numpy(), np.asarray([n], np.int64))


class Run:
    """One run of a training cell on one device."""

    def __init__(self, cell: Dict, *, seed: int, device, t0: float):
        self.cell = cell
        self.t = cell["traffic"]
        self.flags = cell["config"]["flags"]
        self.family = registry.family(self.flags["model"], cell["root"])
        self.seed = seed
        self.device = torch.device(device)
        self.t0 = t0
        self.bs = int(self.t["batch_per_card"])
        self.k = int(self.t["steps_per_loop"])

    # -- set-up ------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        from deepfm_tpu_torch.train.loop import Trainer  # noqa: PLC0415
        self.stages = [("start to set-up", time.time() - self.t0)]
        mark = time.time()

        def stage(name: str) -> None:
            nonlocal mark
            now = time.time()
            self.stages.append((name, now - mark))
            mark = now

        cfg = program_config(self.cell, self.seed)
        # The rows, made on the card and handed to the program as host
        # columns (what a decoded cache holds).
        dev_cols = self.family.columns(self.cell, self.seed, self.device)
        self.cols = host_columns(dev_cols)
        del dev_cols
        g = gen.generator(self.seed, self.device, gen.ORDERS)
        n = self.cols.num_records
        self.orders = [torch.randperm(n, generator=g, device=self.device)
                       .to(torch.int32).cpu().numpy()
                       for _ in range(int(self.t["epoch_orders"]))]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        stage("rows")
        self.trainer = Trainer(cfg, device=self.device)
        self.state = self.trainer.init_state()
        shapes = {k: tuple(v.shape) for k, v in self.state.params.items()}
        w0 = self.family.weights(self.cell, shapes, self.seed, self.device)
        self.trainer.load_weights(self.state, w0, dict(
            self.state.model_state))
        self.w0 = self.family.hold(w0, self.cell, self.seed)
        del w0
        self.step_shapes = self.family.step_shapes(self.flags, self.bs,
                                                   shapes)
        self.feed = ResidentFeed(self.cols, self.bs, self.orders,
                                 f"perfbench-{self.seed}")
        why = self.trainer.device_dataset_ineligible(self.feed)
        if why is not None:
            raise RuntimeError(f"the resident feed is refused: {why}")
        stage("program and weights")
        self._checked_steps()
        stage("checked steps")
        # Warm-up: one dispatch of the window's depth.
        self._fit(self.k)
        self._sync()
        stage("warm-up")
        self.setup_s = time.time() - self.t0

    def _fit(self, steps: int, hooks=None):
        """``steps`` steps through the window's call; returns its result."""
        self.feed.advance(steps)
        self.state, out = self.trainer.fit_device_resident(
            self.state, self.feed, max_steps=steps, hooks=hooks)
        return out

    def _checked_steps(self) -> None:
        """The first steps, one dispatch each, recording what the
        reference checks: each step's loss, the first gradient as the
        optimizer got it (the family's read of its state) and every leaf's
        change."""
        losses: List[torch.Tensor] = []
        grad1: Dict[str, float] = {}

        def hook(state, m):
            losses.append(m["loss"].detach().clone())
            if len(losses) == 1:
                grad1.update(self.family.first_grad_norms(state.opt_state))

        self._fit(int(self.t["checked_steps"]), hooks=[hook])
        change = {k: float(torch.linalg.vector_norm(
            (v.detach() - self.w0[k].to(self.device)).double()))
            for k, v in self.state.params.items()}
        self.checked = {"losses": [float(x) for x in losses],
                        "grad1": grad1, "change": change}

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> Dict:
        """Calls of ``steps_per_call`` steps until ``seconds`` have passed:
        every example and all the time of the window."""
        per_call = int(self.t["steps_per_call"])
        steps = 0
        self._sync()
        start = time.perf_counter()
        while True:
            out = self._fit(per_call)
            steps += int(out["steps"])
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        self.last_loss = float(out["loss"])
        return {"steps": steps, "seconds": elapsed,
                "examples_per_s": steps * self.bs / elapsed}

    def traced_window(self) -> Dict:
        """``trace_steps`` steps under the profiler and the program's span
        tracer: the per-layer readers' context."""
        from deepfm_tpu_torch.obs import trace as obs_trace  # noqa: PLC0415
        n = int(self.t["trace_steps"])
        obs_trace.configure("full", export_env=False)
        self._sync()
        out, ops, t0, t1 = device_trace.profile(
            lambda: self._fit(n), self._sync)
        with tempfile.TemporaryDirectory(prefix="perfbench-spans-") as d:
            with open(obs_trace.export(os.path.join(d, "spans.json"))) as f:
                events = json.load(f)["traceEvents"]
        obs_trace.reset()
        spans = [e for e in events if e.get("ph") == "X"
                 and t0 <= e["ts"] * 1e3 <= t1]
        self.last_loss = float(out["loss"])
        steps = int(out["steps"])
        eps = steps * self.bs / ((t1 - t0) / 1e9)
        peaks = self.cell["peaks"]
        ctx = device_trace.Context(
            ops=ops, spans=spans, t0=t0, t1=t1, steps=steps,
            examples_per_s=eps, cards=1, shapes=self.step_shapes,
            peaks=peaks, kernel=functools.partial(
                registry.kernel, root=self.cell["root"]))
        return {"ctx": ctx, "steps": steps, "examples_per_s": eps}

    # -- after the window ----------------------------------------------------
    def free_program(self) -> None:
        self.trainer = self.state = self.feed = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_batches(self) -> List[Dict[str, torch.Tensor]]:
        """The rows of the checked steps, in the order the program met
        them: the first rows of the feed's first permutation."""
        n, b = int(self.t["checked_steps"]), self.bs
        idx = self.orders[0][:n * b]
        cols = {"label": self.cols.labels[idx], "ids": self.cols.ids[idx],
                "vals": self.cols.vals[idx]}
        cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in cols.items()}
        return [{k: v[i * b:(i + 1) * b] for k, v in cols.items()}
                for i in range(n)]

    def reference(self, **kw) -> Dict:
        """The family's reference over the checked steps (``kw``: the
        control's ``quant``, a fault's ``rows``)."""
        return self.family.reference(self.cell, self.w0,
                                     self.reference_batches(), self.device,
                                     **kw)
