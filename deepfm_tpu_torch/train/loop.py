"""Trainer: train, eval and predict steps and the fit loop on one device
(port of ``deepfm_tpu.train.loop``).

The model module is a stateless template built on the ``meta`` device; a
:class:`TrainState` carries the tensors, and every step runs the module
over them with ``torch.func.functional_call``, so two states never share
storage. A dense train step is the JAX ``_step_impl``: forward in training
mode, loss = mean per-example loss + l2 over the full embedding tables (pad
rows excluded), gradients of both, pad-row gradients zeroed, then the
optimizer updates every parameter in place. With ``--embedding_update
sparse`` a step is the JAX ``_sparse_step_impl`` on one device, in either
table layout: the embedding tables move only in the rows the batch touched,
by lazy Adam (see ``_sparse_step_impl``), and the other params take the
optimizer.

``multi_step`` runs ``steps_per_loop`` steps per dispatch as a Python loop
(the JAX package's ``lax.scan``), bit-identical to as many ``train_step``
calls. Under ``--grad_accum_steps a`` it regroups the dispatch's k
microbatches into k // a accumulated optimizer applies
(``_accum_step_impl``, ``_sparse_accum_step_impl``) and k % a full single
steps; ``state.step`` counts microbatches, the optimizers' ``count`` counts
applies.

``fit`` fires its hooks once per dispatch and reads the loss back to the
host only at the ``log_steps`` cadence, so the host stays ahead of the
card. Host batches reach the card through the device staging ring
(``_StagingRing``, ``--staging_buffers`` slots of preallocated pinned and
device memory, copied on a stream of their own) from a staging thread
``--transfer_ahead`` groups ahead (inline at 0). A source with
``iter_superbatches`` (the pooled ``CtrPipeline``) is staged as its
contiguous k-batch emissions, so the dispatch grouping is the pipeline's,
short groups at pool boundaries included. Under ``--on_nonfinite
skip|rollback`` every dispatch is checked (``NonFiniteGuard``): a skip
restores the state snapshot taken before the dispatch, a rollback raises
``RollbackSignal`` for the task driver. ``--dispatch_timeout_s`` starts
the stall watchdog.

With ``--embedding_tiering hot_cold`` (sparse update, monolithic table)
the tables and their lazy-Adam slots live in host RAM and only
``--embedding_hot_rows`` rows are on the device (``data.hot_cold``): ``fit``
plans each dispatch group ``--transfer_ahead`` groups early on the staging
thread (cold fetches and the id -> slot remap, numpy only), stages the
remapped group through the same ring, applies the group's cache
transaction on the fit thread just before its dispatch, and
``evaluate``/``predict`` run on the densified full tables.

``fit_device_resident`` (``--device_dataset``) uploads the decoded epoch's
columns to the card once per cache fingerprint; each dispatch slices its
rows' indices at a cursor and gathers the batches on the card, then runs
the same steps as ``fit`` over the same batch order, so the two are
bit-identical.

Not ported yet, raising ``NotImplementedError`` naming its flag: a mesh
other than 1x1.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, \
    Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..config import Config
from ..data import pipeline as pipe_lib
from ..models import get_model
from ..obs import trace as trace_lib
from ..ops import embedding as emb_ops
from ..ops import embedding_kernels as ek
from ..utils import device as device_lib
from ..utils import profiling as prof_lib
from . import guard as guard_lib
from . import metrics as metrics_lib
from . import optimizers as opt_lib
from .state import StateSnapshot, TrainState

log = logging.getLogger(__name__)

Batch = Dict[str, np.ndarray]


def pad_batch(batch: Batch, bs: int) -> Batch:
    """Pad a short tail batch up to ``bs`` rows by repeating the last row.
    Callers trim the padded rows from the output (predict) or give them a
    zero weight (evaluate)."""
    n = batch["label"].shape[0]
    pad = bs - n
    return {k: np.concatenate([v, np.tile(v[-1:], (pad,) + (1,) * (v.ndim - 1))])
            for k, v in batch.items()}


def zero_batch(field_size: int, bs: int) -> Batch:
    """All-zero batch with the canonical CTR schema."""
    return {
        "feat_ids": np.zeros((bs, field_size), np.int32),
        "feat_vals": np.zeros((bs, field_size), np.float32),
        "label": np.zeros((bs, 1), np.float32),
    }


def _with_weight(batch: Batch, bs: int) -> Batch:
    """Attach a per-row validity weight and pad to ``bs`` rows: real rows
    weigh 1, padding 0, so tail records count once and padding not at
    all."""
    n = batch["label"].shape[0]
    bs = max(bs, n)
    w = np.zeros((bs, 1), np.float32)
    w[:n] = 1.0
    if n < bs:
        batch = pad_batch(batch, bs)
    return {**batch, "weight": w}


def check_ported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a Trainer option that the port has
    not reached yet, naming its flag."""
    unported = [
        (cfg.mesh_data > 1 or cfg.mesh_model > 1,
         f"--mesh_data {cfg.mesh_data} --mesh_model {cfg.mesh_model} (a mesh "
         "other than 1x1)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not yet ported to deepfm_tpu_torch")


def _staged_records(args) -> int:
    """Record count of a staged transfer's host payload (a batch dict or a
    list of them); 0 for anything without a ``label`` column."""
    for a in args:
        if isinstance(a, dict) and "label" in a:
            return int(a["label"].shape[0])
        if isinstance(a, (list, tuple)) and a and isinstance(a[0], dict):
            return sum(int(b["label"].shape[0]) for b in a
                       if isinstance(b, dict) and "label" in b)
    return 0


class RingClosed(RuntimeError):
    """A transfer asked of a staging ring after its fit ended."""


class _StagingRing:
    """Bounded device staging area: at most ``n_slots`` dispatch groups are
    transferred ahead of the dispatches that consume them (the JAX
    package's ``_StagingRing``).

    The staging thread calls :meth:`put` around each host->device transfer
    (:meth:`stage` is the slot transfer itself); the fit thread calls
    :meth:`retire` after each dispatch. Transfer j fences on dispatch
    j - n_slots: with 2 slots dispatch k+1's transfer runs while dispatch k
    computes (double buffering), with 1 slot every transfer waits out the
    previous dispatch. A scheduling constraint only: the trajectory is
    bit-identical across slot counts.

    On the card each slot is a preallocated pinned host buffer and a
    preallocated device buffer per batch column, sized for the first group
    (k batches); shorter groups use views of it. The staging thread fills
    slot j % n, copies it to the device on a copy stream of the ring's own
    and records a copy event; the fit thread makes its stream wait on that
    event before the dispatch (:meth:`wait`) and records a fence event
    after it (:meth:`retire`); transfer j synchronizes fence j - n before it
    rewrites slot j % n, host side and device side. The device buffers are
    allocated on the compute stream and live as long as the ring, so the
    caching allocator never hands them to another stream. On the CPU the
    ring keeps its slot discipline and timing with no streams: the slot's
    host buffer is the batch.

    ``transfer_s`` is the time inside transfers (the fill and the copy, to
    its completion), ``wait_s`` the time blocked on fences;
    ``overlap_fraction`` is the share of staging time doing transfer work
    (1.0 = never fenced)."""

    # Test/bench only: inflate each transfer by N ns per staged record, so
    # a CPU run has a transfer to overlap (never set in production).
    SYNTH_TRANSFER_ENV = "DEEPFM_TPU_TORCH_SYNTH_TRANSFER_NS_PER_RECORD"

    def __init__(self, n_slots: int, device="cpu"):
        self.n_slots = max(int(n_slots), 1)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._fences: "queue.Queue[Any]" = queue.Queue()
        self._closed = threading.Event()
        self._lock = threading.Lock()
        self._staged = 0
        self._slots: List[Optional[Dict[str, Tuple]]] = [None] * self.n_slots
        self.transfer_s = 0.0
        self.wait_s = 0.0
        self._synth_ns = int(os.environ.get(self.SYNTH_TRANSFER_ENV, "0"))
        if self._cuda:
            self._compute = torch.cuda.current_stream(self.device)
            self._copy = torch.cuda.Stream(self.device)

    def put(self, transfer: Callable[[], Any], n_records: int = 0) -> Any:
        """Run one transfer under the slot discipline (staging thread)."""
        self._staged += 1
        if self._staged > self.n_slots:
            with trace_lib.span("stage.wait", slot=self._staged):
                t0 = time.time()
                fence = None
                # Poll against close, so an abandoned fit never strands the
                # staging thread on this queue.
                while not self._closed.is_set():
                    try:
                        fence = self._fences.get(timeout=0.1)
                        break
                    except queue.Empty:
                        continue
                if fence is not None:
                    fence.synchronize()
                self.wait_s += time.time() - t0
        with self._lock:
            if self._closed.is_set():
                raise RingClosed("staging ring closed: its fit ended")
            with trace_lib.span("stage.transfer", records=n_records):
                t0 = time.time()
                out = transfer()
                if self._synth_ns and n_records:
                    time.sleep(self._synth_ns * n_records * 1e-9)
                self.transfer_s += time.time() - t0
        return out

    def stage(self, group: List[Batch]):
        """Transfer one dispatch group into the next slot: (device batches,
        copy event or None). The batches are views of the slot."""
        slot = self._staged % self.n_slots
        bounds = [0]
        for b in group:
            bounds.append(bounds[-1] + int(b["label"].shape[0]))
        return self.put(lambda: self._fill(slot, group, bounds),
                        _staged_records((group,)))

    def stage_rows(self, rows: Batch, m: int):
        """Transfer one contiguous emission of ``m`` equal batches (a
        superbatch's ``[m * B, ...]`` rows) into the next slot with one copy
        per column: (m device batches, copy event or None)."""
        slot = self._staged % self.n_slots
        n = int(rows["label"].shape[0])
        bs = n // m
        bounds = [i * bs for i in range(m)] + [n]
        return self.put(lambda: self._fill(slot, [rows], bounds),
                        _staged_records((rows,)))

    def _alloc(self, group: List[Batch]) -> Dict[str, Tuple]:
        rows = sum(int(b["label"].shape[0]) for b in group)
        out = {}
        for key, v in group[0].items():
            dtype = torch.from_numpy(np.ascontiguousarray(v[:0])).dtype
            shape = (rows,) + tuple(v.shape[1:])
            host = torch.empty(shape, dtype=dtype, pin_memory=self._cuda)
            dev = host
            if self._cuda:
                with torch.cuda.stream(self._compute):
                    dev = torch.empty(shape, dtype=dtype, device=self.device)
            out[key] = (host, dev)
        return out

    def _fits(self, cols: Optional[Dict[str, Tuple]],
              group: List[Batch]) -> bool:
        if cols is None or set(cols) != set(group[0]):
            return False
        rows = sum(int(b["label"].shape[0]) for b in group)
        for key, (host, _) in cols.items():
            v = group[0][key]
            if (host.shape[0] < rows or tuple(host.shape[1:]) != v.shape[1:]
                    or host.dtype != torch.from_numpy(
                        np.ascontiguousarray(v[:0])).dtype):
                return False
        return True

    def _fill(self, slot: int, parts: List[Batch], bounds: List[int]):
        """Copy ``parts`` (host row blocks) end to end into the slot and
        cut the device copy into batches at ``bounds``."""
        ctx = (torch.cuda.device(self.device) if self._cuda
               else contextlib.nullcontext())
        with ctx:
            if not self._fits(self._slots[slot], parts):
                self._slots[slot] = self._alloc(parts)
            cols = self._slots[slot]
            offs = [0]
            for b in parts:
                offs.append(offs[-1] + int(b["label"].shape[0]))
            for key, (host, _) in cols.items():
                for b, o0, o1 in zip(parts, offs[:-1], offs[1:]):
                    host[o0:o1].copy_(torch.from_numpy(
                        np.ascontiguousarray(b[key])))
            ready = None
            if self._cuda:
                with torch.cuda.stream(self._copy):
                    for host, dev in cols.values():
                        dev[:offs[-1]].copy_(host[:offs[-1]],
                                             non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._copy)
                ready.synchronize()
        dev_batches = [{key: dev[o0:o1] for key, (_, dev) in cols.items()}
                       for o0, o1 in zip(bounds[:-1], bounds[1:])]
        return dev_batches, ready

    def wait(self, ready) -> None:
        """Make the fit thread's stream wait for a staged copy."""
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)

    def retire(self) -> None:
        """Mark the dispatch just enqueued: its slot is reusable once the
        fence completes (fit thread). On the card the fence is an event
        recorded on the fit thread's stream now; on the CPU the dispatch has
        already run."""
        fence = None
        if self._cuda:
            fence = torch.cuda.Event()
            fence.record(torch.cuda.current_stream(self.device))
        self._fences.put(fence)

    def close(self) -> None:
        """Stop staging: a parked transfer drops out, a running one is
        waited out, and no copy stays in flight on the ring's buffers."""
        self._closed.set()
        with self._lock:
            if self._cuda:
                self._copy.synchronize()

    def overlap_fraction(self) -> float:
        total = self.transfer_s + self.wait_s
        return 1.0 if total <= 0 else self.transfer_s / total


class Trainer:
    """Runs the train, eval and predict steps of one model on one device."""

    def __init__(self, cfg: Config, *, device="cuda"):
        check_ported(cfg)
        self.cfg = cfg
        self.device = device_lib.resolve(device)
        self.model = get_model(cfg, device="meta")
        self.opt = opt_lib.build_optimizer(cfg, world_size=1)
        self._embed_names = self.model.embedding_param_names()
        # Sparse (touched-rows-only) embedding updates with lazy Adam; the
        # tables' flat state names, and the rest of the params, which the
        # base optimizer updates.
        self.sparse_embed = cfg.embedding_update == "sparse"
        emb = self.model.emb
        self._embed_keys = {n: {k: emb.param_key(n, k)
                                for k in emb.table_keys()}
                            for n in self._embed_names}
        embed_flat = {p for keys in self._embed_keys.values()
                      for p in keys.values()}
        self._rest_keys = [k for k, _ in self.model.named_parameters()
                           if k not in embed_flat]
        # Hot/cold tiered embedding storage (config-validated: sparse
        # update, monolithic table).
        self._tier = None
        if cfg.embedding_tiering == "hot_cold":
            from ..data import hot_cold  # noqa: PLC0415
            self._tier = hot_cold.TieredEmbeddingRuntime(cfg, self.model)
        # Microbatches per optimizer apply (config-validated: divides
        # steps_per_loop; no tiering, no device dataset).
        self._accum = max(int(cfg.grad_accum_steps), 1)
        # The active fit's staging ring (None outside fit).
        self._ring: Optional[_StagingRing] = None
        # The stall watchdog's abort hook (None: os._exit(EXIT_WATCHDOG)).
        self.watchdog_abort: Optional[Callable[[str], None]] = None
        # The device-resident dataset: (cache fingerprint, device columns).
        self._dd_cols: Optional[Tuple[str, Dict[str, torch.Tensor]]] = None

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None, *,
                   tiered: bool = True) -> TrainState:
        """Fresh state: weights drawn from a generator seeded with ``seed``
        (default ``cfg.seed``) on the trainer's device; the dropout
        generator seeded with ``seed + 1``. Under hot/cold tiering the
        state is adopted into the tier; ``tiered=False`` returns the DENSE
        state instead, the template a tiered run restores its (densified)
        checkpoints into before ``self._tier.adopt``."""
        seed = self.cfg.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model = get_model(self.cfg, device=self.device, generator=gen)
        params = {k: v.detach().requires_grad_()
                  for k, v in model.named_parameters()}
        model_state = {k: v.detach() for k, v in model.named_buffers()}
        opt_state = self._init_opt_state(
            {k: v.detach() for k, v in params.items()})
        rng = torch.Generator(device=self.device).manual_seed(seed + 1)
        state = TrainState(step=0, params=params, opt_state=opt_state,
                           model_state=model_state, rng=rng)
        if tiered and self._tier is not None:
            state = self._tier.adopt(state)
        return state

    def _init_opt_state(self, params: Dict[str, torch.Tensor]) -> dict:
        """Dense: the optimizer's state over all params. Sparse: the
        JAX package's ``{"base", "embed", "count"}`` layout, the optimizer
        over the non-embedding params, lazy-Adam slots per (param, table)
        and the embeddings' step count (a host int)."""
        if not self.sparse_embed:
            return self.opt.init(params)
        embed = {n: {k: opt_lib.embed_adam_init(params[p])
                     for k, p in keys.items()}
                 for n, keys in self._embed_keys.items()}
        return {"base": self.opt.init({k: params[k] for k in self._rest_keys}),
                "embed": embed, "count": 0}

    def load_weights(self, state: TrainState,
                     params: Dict[str, torch.Tensor],
                     model_state: Dict[str, torch.Tensor]) -> TrainState:
        """Copy flat ``{name: tensor}`` weights (``params_from_jax``, an
        artifact's) into ``state``, in place; returns the state. Under
        tiering, load into ``init_state(tiered=False)``, then adopt."""
        with torch.no_grad():
            for src, dst in ((params, state.params),
                             (model_state, state.model_state)):
                if set(src) != set(dst):
                    raise ValueError(f"weights {sorted(src)} do not match "
                                     f"the model's {sorted(dst)}")
                for k, v in src.items():
                    dst[k].copy_(v)
        return state

    def servable_model(self, state: TrainState) -> torch.nn.Module:
        """An eval-mode module holding ``state``'s weights (for export)."""
        model = get_model(self.cfg, device="meta")
        model.load_state_dict(
            {k: v.detach() for k, v in {**state.params,
                                        **state.model_state}.items()},
            assign=True)
        return model.eval()

    def put_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """Host numpy batch -> tensors on the trainer's device (pinned host
        memory and ``non_blocking`` copies on the card)."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
            self.device, non_blocking=True) for k, v in batch.items()}

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def _logits(self, state: TrainState, batch: Dict[str, torch.Tensor], *,
                train: bool, **emb_kw) -> torch.Tensor:
        """The model over ``state``'s tensors; ``emb_kw`` (``emb_rows``,
        ``emb_plan``) feeds the sparse update's row leaves."""
        self.model.train(train)
        return functional_call(
            self.model, {**state.params, **state.model_state},
            (batch["feat_ids"], batch["feat_vals"]),
            {"generator": state.rng if train else None, **emb_kw})

    def _per_example_loss(self, logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
        """``optax.sigmoid_binary_cross_entropy`` for log_loss; the squared
        error of the probability for square_loss."""
        if self.cfg.loss_type == "log_loss":
            return (-labels * F.logsigmoid(logits)
                    - (1.0 - labels) * F.logsigmoid(-logits))
        return torch.square(torch.sigmoid(logits) - labels)

    def loss_and_grads(self, state: TrainState,
                       batch: Dict[str, torch.Tensor]):
        """Training-mode forward and backward: ``(loss, xent, grads)`` with
        loss = xent + l2 and pad-row gradients zeroed. Updates the BN
        running statistics in ``state`` and draws from its generator."""
        names = list(state.params)
        with torch.enable_grad():
            logits = self._logits(state, batch, train=True)
            labels = batch["label"].reshape(-1).float()
            xent = torch.mean(self._per_example_loss(logits, labels))
            loss = xent + self.model.l2_loss(state.params)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [state.params[n] for n in names])))
        # Pad rows never move: their gradient is already zero (no real id
        # reaches them; the l2 term excludes them), and this makes it so.
        for keys in self._embed_keys.values():
            for p in keys.values():
                grads[p] = self.model.emb.mask_pad_grads(grads[p])
        return loss.detach(), xent.detach(), grads

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on a device batch; updates ``state`` in place
        and returns it with the step's ``loss`` and ``xent`` (on the
        device: reading them waits for the card)."""
        if self.sparse_embed:
            return self._sparse_step_impl(state, batch)
        loss, xent, grads = self.loss_and_grads(state, batch)
        self.opt.apply(state.params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss, "xent": xent}

    # -- sparse embedding update ----------------------------------------
    def _tables(self, state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
        """{param name: {table key: table}} of ``state``."""
        return {n: {k: state.params[p] for k, p in keys.items()}
                for n, keys in self._embed_keys.items()}

    def _use_fused_backward(self) -> bool:
        """The fused formulation: the [B, F, D] batch views of each table
        are the gradient leaves (no plan), every name's cotangents land in
        one table-shaped scatter-add with an occupancy column, and lazy Adam
        runs as a masked table sweep. Monolithic layout only;
        ``--embedding_kernels off`` switches back to the plan path."""
        return self.cfg.embedding_kernels != "off" and not self.model.emb.hashed

    def _fused_tables_ok(self, tabs: Dict[str, torch.Tensor]) -> bool:
        heights = {t.shape[0] for t in tabs.values()}
        return (len(heights) == 1
                and all(t.dim() in (1, 2) for t in tabs.values())
                and heights.pop() <= ek.PLAN_COUNT_MAX_ROWS)

    def _fused_grad_ext(self, tabs: Dict[str, torch.Tensor],
                        ids: torch.Tensor,
                        g_views: Dict[str, torch.Tensor]) -> torch.Tensor:
        """ONE table-shaped scatter-add for the whole embedding plane:
        column 0 counts each row's occurrences (the touch marks: exact
        integers in float32), the other columns sum every name's
        per-position cotangents. An id in [-V, 0) adds to row id + V and any
        other out-of-range id adds nothing, as the JAX scatter does (it
        goes to an extra row that is dropped).

        The sum is ``ek.segment_sum``: each row's cotangents in ascending
        position from 0.0, the JAX package's order, through one take
        backward launch on the card (``index_add_`` on the CPU, and on the
        card under ``--embedding_kernels xla``, where its float atomics
        may add in another order from run to run)."""
        rows = next(iter(tabs.values())).shape[0]
        flat = ids.reshape(-1).long()
        flat = torch.where(flat < 0, flat + rows, flat)
        flat = torch.where((flat >= 0) & (flat < rows), flat,
                           torch.full((), rows, dtype=flat.dtype,
                                      device=flat.device))
        n_pos = flat.shape[0]
        cols = [torch.ones((n_pos, 1), dtype=torch.float32,
                           device=flat.device)]
        cols += [g_views[n].reshape(n_pos, -1).float()
                 for n in self._embed_names]
        gcat = torch.cat(cols, dim=1)
        return ek.segment_sum(gcat, flat, rows + 1,
                              mode=self.cfg.embedding_kernels)[:rows]

    @torch.no_grad()
    def _fused_apply(self, state: TrainState,
                     tabs: Dict[str, torch.Tensor], gext: torch.Tensor,
                     count: int) -> torch.Tensor:
        """Masked lazy-Adam sweep per name over ``gext``'s columns (plus the
        touched-rows-only L2 gradient, added here as autograd adds it on the
        plan path), in place. Returns the l2 term's value.

        The idle decays are computed once and shared by every table (tau is
        the same across them: the same touched set every step), as
        ``exp2(idle * float32(log2 b))``: the JAX package's formulation on
        this leg, ~1 ulp from ``pow``."""
        touched = gext[:, 0] > 0
        opt_embed = state.opt_state["embed"]
        mono = self.model.emb.MONO
        l2_reg = self.cfg.l2_reg
        tau = opt_embed[self._embed_names[0]][mono].tau
        idle = (count - tau).float()
        decay = (torch.exp2(idle * float(np.float32(np.log2(0.9)))),
                 torch.exp2(idle * float(np.float32(np.log2(0.999)))))
        l2 = torch.zeros((), dtype=torch.float32, device=gext.device)
        o = 1
        for name in self._embed_names:
            tab = tabs[name]
            d = 1 if tab.dim() == 1 else tab.shape[-1]
            g_eff = gext[:, o:o + d].reshape(tab.shape)
            if l2_reg:
                # l2 of the pre-update rows, before the sweep overwrites them.
                sq = tab.float() * tab.float()
                keep = emb_ops.trailing_dims(touched, sq.dim())
                l2 = l2 + 0.5 * torch.sum(torch.where(
                    keep, sq, torch.zeros((), dtype=sq.dtype,
                                          device=sq.device)))
                g_eff = g_eff + l2_reg * tab.float()
            o += d
            opt_lib.sparse_adam_masked(tab, g_eff, touched,
                                       opt_embed[name][mono], count,
                                       lr=self.opt.lr, decay=decay)
        return l2_reg * l2

    @torch.no_grad()
    def _sparse_apply(self, state: TrainState, plan, rows0, g_rows,
                      count: int) -> None:
        """Lazy-Adam apply and scatter writeback for every (name, table), in
        place. The counting plans' touched/rank companions are stripped
        first, as the JAX trainer strips them, so every leg writes back by
        scatter."""
        plan = {k: e._replace(touched=None, rank=None)
                for k, e in plan.items()}
        opt_embed = state.opt_state["embed"]
        tabs = self._tables(state)
        for name in self._embed_names:
            for key, e in plan.items():
                opt_lib.sparse_apply_rows(
                    rows0[name][key], g_rows[name][key], e,
                    opt_embed[name][key], count, lr=self.opt.lr,
                    table=tabs[name][key])

    def _sparse_step_impl(self, state: TrainState,
                          batch: Dict[str, torch.Tensor]
                          ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One sparse-update optimizer step (the JAX ``_sparse_step_impl``).

        Plan leg: the batch's ids are deduped into one plan per table; the
        touched rows, not the tables, are the gradient leaves, so the
        backward of the positionwise view is a batch-sized segment-sum
        (the take kernels on the card) and lazy Adam touches only those
        rows. Fused leg (monolithic, kernels not off): the [B, F, D] views
        are the leaves and one table-shaped scatter-add gathers their
        cotangents. The leaves are detached tensors differentiated with
        ``torch.autograd.grad``; the rest of the params go through the
        optimizer as on the dense path."""
        emb = self.model.emb
        tabs = self._tables(state)
        rest = [state.params[k] for k in self._rest_keys]
        labels = batch["label"].reshape(-1).float()
        mono = {n: t[emb.MONO] for n, t in tabs.items()} \
            if not emb.hashed else None
        fused = self._use_fused_backward() and self._fused_tables_ok(mono)
        with torch.enable_grad():
            if fused:
                plan = None
                rows0 = {n: {emb.MONO: emb_ops.lookup(t, batch["feat_ids"])}
                         for n, t in mono.items()}
            else:
                plan = emb.sparse_plan(batch["feat_ids"])
                rows0 = {n: emb.gather_rows(emb.from_tables(tabs[n]), plan)
                         for n in self._embed_names}
            leaves = {n: {k: r.detach().requires_grad_()
                          for k, r in rows.items()}
                      for n, rows in rows0.items()}
            logits = self._logits(state, batch, train=True, emb_rows=leaves,
                                  emb_plan=plan)
            xent = torch.mean(self._per_example_loss(logits, labels))
            loss = xent
            if not fused:
                # Touched-rows-only l2: idle rows do not decay between
                # touches. (The fused leg adds it in ``_fused_apply``.)
                l2 = self.model.l2_loss(emb_rows=leaves, emb_plan=plan)
                loss = xent + l2
            flat = [(n, k) for n in self._embed_names for k in leaves[n]]
            grads = torch.autograd.grad(
                loss, [leaves[n][k] for n, k in flat] + rest)
        g_rows = {n: {} for n in self._embed_names}
        for (n, k), g in zip(flat, grads):
            g_rows[n][k] = g
        opt = state.opt_state
        self.opt.apply({k: state.params[k] for k in self._rest_keys},
                       dict(zip(self._rest_keys, grads[len(flat):])),
                       opt["base"])
        count = opt["count"] + 1
        if fused:
            gext = self._fused_grad_ext(
                mono, batch["feat_ids"],
                {n: g[emb.MONO] for n, g in g_rows.items()})
            l2 = self._fused_apply(state, mono, gext, count)
        else:
            self._sparse_apply(state, plan, rows0, g_rows, count)
        opt["count"] = count
        state.step += 1
        return state, {"loss": (xent + l2).detach(), "xent": xent.detach()}

    # -- gradient accumulation -------------------------------------------
    def _accum_step_impl(self, state: TrainState,
                         batches: List[Dict[str, torch.Tensor]]
                         ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """ONE optimizer apply over ``a`` microbatches (the JAX
        ``_accum_step_impl``).

        The loss is the mean of the microbatch mean losses (for equal
        microbatches the big-batch mean over a*B examples), plus the l2
        term once per apply over the full tables. Each microbatch runs its
        forward and its backward before the next forward, with the
        cotangent float32(1/a), so activation memory peaks at one
        microbatch; the BN running statistics and the dropout generator
        carry from microbatch to microbatch in ``state``. The gradients sum
        in microbatch order, g_0 + g_1 + ... + g_{a-1}, then the l2 term's:
        a fixed order of exact per-microbatch gradients (the dense lookups
        sum theirs in position order, ``ek.index_rows``), so the result is
        the same on every run. ``state.step`` advances by ``a``; the
        optimizer's ``count`` (Adam's bias correction) by one."""
        if self.sparse_embed:
            return self._sparse_accum_step_impl(state, batches)
        a = len(batches)
        names = list(state.params)
        params = [state.params[n] for n in names]
        scale = torch.full((), 1.0 / a, dtype=torch.float32,
                           device=self.device)
        grads: Optional[List[torch.Tensor]] = None
        xent_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for batch in batches:
            with torch.enable_grad():
                logits = self._logits(state, batch, train=True)
                labels = batch["label"].reshape(-1).float()
                xent = torch.mean(self._per_example_loss(logits, labels))
                g = list(torch.autograd.grad(xent, params,
                                             grad_outputs=scale))
            if grads is None:
                grads = g
            else:
                torch._foreach_add_(grads, g)
            xent_sum = xent_sum + xent.detach()
        with torch.enable_grad():
            l2 = self.model.l2_loss(state.params)
            g_l2 = torch.autograd.grad(l2, params, allow_unused=True)
        for g, gi in zip(grads, g_l2):
            if gi is not None:
                g.add_(gi)
        gd = dict(zip(names, grads))
        for keys in self._embed_keys.values():
            for p in keys.values():
                gd[p] = self.model.emb.mask_pad_grads(gd[p])
        self.opt.apply(state.params, gd, state.opt_state)
        state.step += a
        xent = xent_sum / a
        return state, {"loss": (xent + l2).detach(), "xent": xent}

    def _sparse_accum_step_impl(self, state: TrainState,
                                batches: List[Dict[str, torch.Tensor]]
                                ) -> Tuple[TrainState,
                                           Dict[str, torch.Tensor]]:
        """Sparse-update accumulation: ONE merged plan per apply (the JAX
        ``_sparse_accum_step_impl``).

        Plan leg (hashed tables; monolithic with ``--embedding_kernels
        off``): the group's [a*B, F] ids dedup into one plan per table (one
        plan launch and one segments launch for every hashed table on the
        card), the touched rows are gathered once, and each name's group
        view [a*B, F, D] comes from one fused take over the merged inv.
        Microbatch i's slice of the view is its autograd leaf; after the
        last microbatch, one take backward per name over the merged plan's
        segments turns the stacked slice cotangents into the row gradient,
        the touched-rows l2 gradient is added once, and lazy Adam applies
        once. An apply thus launches the plan, segments and take kernels as
        often as one step does; the result differs from the JAX package's
        AD order by float reassociation only.

        Fused leg (monolithic, kernels not off): the [a*B, F, D] views of
        the tables are gathered once, their microbatch slices are the
        leaves, and the stacked cotangents go into ONE ``ek.segment_sum``
        over the a*B*F positions (one segments launch and one take backward
        per apply), the JAX package's group-position order.

        The other params' gradients sum in microbatch order, as on the
        dense path; ``state.step`` advances by ``a``, the embeddings'
        ``count`` and the base optimizer's by one."""
        emb = self.model.emb
        a = len(batches)
        names = self._embed_names
        tabs = self._tables(state)
        rest = [state.params[k] for k in self._rest_keys]
        mono = {n: t[emb.MONO] for n, t in tabs.items()} \
            if not emb.hashed else None
        fused = self._use_fused_backward() and self._fused_tables_ok(mono)
        ids = torch.cat([b["feat_ids"] for b in batches])
        offs = [0]
        for b in batches:
            offs.append(offs[-1] + int(b["feat_ids"].shape[0]))
        if fused:
            plan = None
            with torch.no_grad():
                views = {n: emb_ops.lookup(t, ids) for n, t in mono.items()}
        else:
            plan = emb.sparse_plan(ids)
            with torch.no_grad():
                rows0 = {n: emb.gather_rows(emb.from_tables(tabs[n]), plan)
                         for n in names}
            leaves = {n: {k: r.detach().requires_grad_()
                          for k, r in rows.items()}
                      for n, rows in rows0.items()}
            with torch.enable_grad():
                group = {n: emb.lookup_rows(leaves[n], plan) for n in names}
            views = {n: v.detach() for n, v in group.items()}
        g_views = {n: torch.empty_like(v) for n, v in views.items()}
        scale = torch.full((), 1.0 / a, dtype=torch.float32,
                           device=self.device)
        g_rest: Optional[List[torch.Tensor]] = None
        xent_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for batch, o0, o1 in zip(batches, offs[:-1], offs[1:]):
            leaf = {n: views[n][o0:o1].detach().requires_grad_()
                    for n in names}
            with torch.enable_grad():
                logits = self._logits(
                    state, batch, train=True,
                    emb_rows={n: {emb.MONO: leaf[n]} for n in names},
                    emb_plan=None)
                labels = batch["label"].reshape(-1).float()
                xent = torch.mean(self._per_example_loss(logits, labels))
                grads = torch.autograd.grad(
                    xent, [leaf[n] for n in names] + rest,
                    grad_outputs=scale)
            for n, g in zip(names, grads):
                g_views[n][o0:o1].copy_(g)
            g = list(grads[len(names):])
            if g_rest is None:
                g_rest = g
            else:
                torch._foreach_add_(g_rest, g)
            xent_sum = xent_sum + xent.detach()
        xent = xent_sum / a
        opt = state.opt_state
        self.opt.apply({k: state.params[k] for k in self._rest_keys},
                       dict(zip(self._rest_keys, g_rest)), opt["base"])
        count = opt["count"] + 1
        if fused:
            gext = self._fused_grad_ext(mono, ids, g_views)
            l2 = self._fused_apply(state, mono, gext, count)
        else:
            flat = [(n, k) for n in names for k in leaves[n]]
            with torch.enable_grad():
                l2 = self.model.l2_loss(emb_rows=leaves, emb_plan=plan)
                grads = torch.autograd.grad(
                    [group[n] for n in names] + [l2],
                    [leaves[n][k] for n, k in flat],
                    grad_outputs=[g_views[n] for n in names]
                    + [torch.ones_like(l2)])
            g_rows = {n: {} for n in names}
            for (n, k), g in zip(flat, grads):
                g_rows[n][k] = g
            self._sparse_apply(state, plan, rows0, g_rows, count)
        opt["count"] = count
        state.step += a
        return state, {"loss": (xent + l2).detach(), "xent": xent}

    def multi_step(self, state: TrainState,
                   batches: List[Dict[str, torch.Tensor]]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """K microbatches in one dispatch; the last apply's metrics. Without
        accumulation K optimizer steps; under ``--grad_accum_steps a`` K // a
        accumulated applies, then K % a full single steps (a ragged tail
        never waits on a partial accumulation group)."""
        a = self._accum
        m: Dict[str, torch.Tensor] = {}
        n_macro = len(batches) // a if a > 1 else 0
        for g in range(n_macro):
            state, m = self._accum_step_impl(state,
                                             batches[g * a:(g + 1) * a])
        for batch in batches[n_macro * a:]:
            state, m = self.train_step(state, batch)
        return state, m

    # ------------------------------------------------------------------
    # Fit
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _guard_verdict(self, guard: guard_lib.NonFiniteGuard,
                       state: TrainState, m: Dict[str, Any]) -> str:
        """Per-dispatch check of the skip/rollback policies: read the
        dispatch's loss back (the one extra device read those policies
        pay), reduce the params' finiteness on the device, classify."""
        loss = float(m["loss"])
        params_bad = (guard.params_nonfinite(state.params)
                      if math.isfinite(loss) else False)
        return guard.observe(loss, int(state.step), params_bad=params_bad)

    def _make_watchdog(self, guard: Optional[guard_lib.NonFiniteGuard],
                       data_health: Any
                       ) -> Optional[guard_lib.StallWatchdog]:
        if self.cfg.dispatch_timeout_s <= 0:
            return None
        return guard_lib.StallWatchdog(
            self.cfg.dispatch_timeout_s,
            health=guard.health if guard is not None else None,
            data_health=data_health, abort=self.watchdog_abort).start()

    def fit(self, state: TrainState, batches: Iterable[Batch], *,
            hooks: Optional[List[Callable]] = None,
            max_steps: Optional[int] = None,
            on_log: Optional[Callable[[int, float, float], None]] = None,
            guard: Optional[guard_lib.NonFiniteGuard] = None
            ) -> Tuple[TrainState, Dict[str, float]]:
        """Train over an iterable of host batches.

        Groups ``cfg.steps_per_loop`` batches per dispatch (a shorter tail
        runs one step per dispatch, as the JAX package stages it), staged
        through the device staging ring ``cfg.transfer_ahead`` groups ahead;
        hooks fire once per dispatch with ``m["steps_done"]``. The loss is
        read back only when a dispatch crosses a ``log_steps`` boundary,
        where ``guard`` under ``abort`` also looks at it. Under ``skip`` or
        ``rollback`` every dispatch is checked before its update is
        accepted: a skip restores the state snapshot taken before the
        dispatch (params, optimizer and model state, the counts and the
        dropout generator) and fires no hooks, as if the dispatch never
        happened; a rollback raises :class:`guard_lib.RollbackSignal` for
        the task driver. The result carries the ring's
        ``staging_overlap_fraction``, ``staging_transfer_s`` and
        ``staging_wait_s``."""
        cfg = self.cfg
        k = max(cfg.steps_per_loop, 1)
        src_health = getattr(batches, "health", None)
        if max_steps is not None:
            batches = itertools.islice(iter(batches), max_steps)
        ring = _StagingRing(cfg.staging_buffers, self.device)
        self._ring = ring
        tier = self._tier
        if tier is not None:
            staged = self._stage_tiered(batches, k, cfg.transfer_ahead,
                                        tier.start_staging())
        else:
            staged = self._stage(batches, k, cfg.transfer_ahead)
        guard_active = guard is not None and guard.per_dispatch
        snapshot = StateSnapshot() if guard_active else None
        watchdog = self._make_watchdog(guard, src_health)
        last_loss = float("nan")
        n_steps = 0
        examples_since_log = 0
        m: Dict[str, Any] = {}
        meter = prof_lib.ThroughputMeter()
        t0 = time.time()
        try:
            for group, ready, n_ex in staged:
                if tier is not None:
                    # This dispatch's cache transaction goes first, on the
                    # stream its step is enqueued on, and before the
                    # guard's snapshot: a skipped dispatch keeps its
                    # installs, so the directory and the cache agree.
                    state = tier.apply_next(state)
                if guard_active:
                    snapshot.take(state)
                    prev_m = m
                ring.wait(ready)
                with trace_lib.span("train.dispatch", steps=len(group),
                                    examples=n_ex):
                    if len(group) == 1:
                        state, m = self.train_step(state, group[0])
                    else:
                        state, m = self.multi_step(state, group)
                # The slot fence goes before the verdict: a skipped
                # dispatch still occupied its slot.
                ring.retire()
                if guard_active:
                    verdict = self._guard_verdict(guard, state, m)
                    if verdict == "skip":
                        state, m = snapshot.restore(state), prev_m
                        if watchdog is not None:
                            watchdog.beat(n_steps)
                        continue
                    if verdict == "rollback":
                        raise guard_lib.RollbackSignal(int(state.step))
                prev_steps = n_steps
                n_steps += len(group)
                examples_since_log += n_ex
                meter.update(n_ex, len(group))
                if watchdog is not None:
                    watchdog.beat(n_steps)
                if cfg.log_steps and (n_steps // cfg.log_steps
                                      > prev_steps // cfg.log_steps):
                    loss = float(m["loss"])  # device sync, bounded by cadence
                    last_loss = loss
                    if guard is not None and not guard_active:
                        guard.observe(loss, state.step, params_bad=(
                            guard.params_nonfinite(state.params)
                            if math.isfinite(loss) else False))
                    eps = examples_since_log / max(time.time() - t0, 1e-9)
                    log.info("step=%d loss=%.5f examples/sec=%.0f",
                             state.step, loss, eps)
                    if src_health is not None and src_health.consume_dirty():
                        log.info("data health: %s", src_health.summary())
                    if on_log is not None:
                        on_log(state.step, loss, eps)
                    t0 = time.time()
                    examples_since_log = 0
                if hooks:
                    m = {**m, "steps_done": len(group)}
                    for hook in hooks:
                        hook(state, m)
        finally:
            if watchdog is not None:
                watchdog.stop()
            # Unpark a staging thread waiting on a slot fence, then close
            # the generator: an abandoned fit (exception, rollback,
            # preemption) leaves no thread, pin or copy behind.
            ring.close()
            self._ring = None
            staged.close()
            if tier is not None:
                # The tier's staging stops and its queued plans apply.
                tier.stop_staging(state)
        if n_steps:
            # Fold the wait for the card into the rate: completed steps,
            # not dispatched ones.
            self._sync()
            meter.record_drain()
            if math.isnan(last_loss):
                last_loss = float(m["loss"])
        out = {"loss": last_loss, "steps": float(n_steps)}
        out.update({k_: v for k_, v in meter.summary().items()
                    if k_ != "steps"})
        out["staging_overlap_fraction"] = ring.overlap_fraction()
        out["staging_transfer_s"] = ring.transfer_s
        out["staging_wait_s"] = ring.wait_s
        if tier is not None:
            out.update({f"hotcold_{k_}": float(v)
                        for k_, v in tier.stats.items()})
            out["hotcold_hit_rate"] = tier.hit_rate()
            out["hotcold_overlap_fraction"] = tier.overlap_fraction()
        return state, out

    def _stage(self, batches: Iterable[Batch], k: int,
               depth: int) -> Iterator[Tuple[List[Dict[str, torch.Tensor]],
                                             Any, int]]:
        """(device group, copy event, examples) per dispatch, in dispatch
        order, each moved to the device through the active fit's staging
        ring, ``depth`` groups ahead on a staging thread (inline when
        ``depth`` is 0). A source with ``iter_superbatches`` gives the
        groups itself, each one contiguous block of rows (m <= k batches,
        the short groups at its pool boundaries included); any other source
        is grouped by ``_groups``."""
        ring = self._ring
        sb_iter = getattr(batches, "iter_superbatches", None)

        def gen():
            if sb_iter is not None and k > 1:
                for rows, m, n_ex in sb_iter(k):
                    dev, ready = ring.stage_rows(rows, m)
                    yield dev, ready, n_ex
                return
            for group in _groups(batches, k):
                n_ex = sum(int(b["label"].shape[0]) for b in group)
                dev, ready = ring.stage(group)
                yield dev, ready, n_ex

        if depth <= 0:
            return gen()
        return pipe_lib.prefetch(gen(), depth)

    def _stage_tiered(self, batches: Iterable[Batch], k: int, depth: int,
                      generation: int
                      ) -> Iterator[Tuple[List[Dict[str, torch.Tensor]],
                                          Any, int]]:
        """Tiered staging: the groups of :meth:`_stage`, each first planned
        by the hot/cold runtime (victims, cold fetches, id -> slot remap;
        numpy only) on the staging thread, then moved to the device through
        the same ring. Plan order is dispatch order: the fit thread applies
        one plan per group it takes."""
        tier, ring = self._tier, self._ring

        def gen():
            for group in _groups(batches, k):
                n_ex = sum(int(b["label"].shape[0]) for b in group)
                dev, ready = ring.stage(
                    tier.plan_group(group, generation=generation))
                yield dev, ready, n_ex

        if depth <= 0:
            return gen()
        return pipe_lib.prefetch(gen(), depth)

    # ------------------------------------------------------------------
    # Device-resident dataset
    # ------------------------------------------------------------------
    def _device_memory_bytes(self) -> int:
        """The card's memory, or 16 GiB on the CPU (as the JAX package
        assumes where the backend reports none), so the budget check runs
        the same way there."""
        if self.device.type == "cuda":
            return int(torch.cuda.get_device_properties(
                self.device).total_memory)
        return 16 << 30

    def device_dataset_ineligible(self, pipe) -> Optional[str]:
        """None when ``fit_device_resident`` reproduces the staged run of
        ``pipe``, else the reason it cannot (the caller warns and stages)."""
        cfg = self.cfg
        if getattr(pipe, "decoded_cache", "off") == "off":
            return "pipeline has no decoded cache (device upload reads the "\
                   "cached columns)"
        if getattr(pipe, "skip_batches", 0):
            return "resume skip_batches offset pending (staged path owns "\
                   "the trained-prefix drop)"
        try:
            cols = pipe.decoded_epoch_columns()
        except Exception as exc:  # noqa: BLE001 (the staged path raises it)
            return f"decoded cache unavailable ({exc})"
        n = cols.num_records
        if n == 0:
            return "empty dataset"
        k = max(cfg.steps_per_loop, 1)
        if pipe.shuffle and n >= max(pipe.shuffle_buffer,
                                     k * pipe.batch_size):
            return (f"shuffle pool smaller than the epoch ({n} records): "
                    "pool drain order depends on chunk arrival and cannot "
                    "be reproduced as a device gather")
        need = cols.nbytes() + n * 4  # the columns and the epoch's index
        budget = int(self._device_memory_bytes()
                     * cfg.device_dataset_hbm_fraction)
        if need > budget:
            return (f"decoded epoch needs ~{need / 2**20:.1f} MiB on the "
                    f"device, over the {budget / 2**20:.1f} MiB budget "
                    f"(device_dataset_hbm_fraction="
                    f"{cfg.device_dataset_hbm_fraction})")
        return None

    def _dd_upload(self, pipe) -> Dict[str, torch.Tensor]:
        """Upload the cached columns once per fingerprint; later epochs and
        later fits over the same data reuse the device copy. The label
        column goes up as [n, 1], the staged batches' layout."""
        fp = pipe.decoded_cache_fingerprint()
        if self._dd_cols is not None and self._dd_cols[0] == fp:
            return self._dd_cols[1]
        self._dd_cols = None  # free the previous dataset first
        cols = pipe.decoded_epoch_columns()
        host = {"label": np.ascontiguousarray(cols.labels, np.float32
                                              ).reshape(-1, 1),
                "feat_ids": np.ascontiguousarray(cols.ids, np.int32),
                "feat_vals": np.ascontiguousarray(cols.vals, np.float32)}
        dev = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        self._dd_cols = (fp, dev)
        return dev

    def _dd_batches(self, cols: Dict[str, torch.Tensor], idx: torch.Tensor,
                    start: int, m: int, bsz: int
                    ) -> List[Dict[str, torch.Tensor]]:
        """The dispatch's ``m`` batches of ``bsz`` rows: the indices at the
        cursor, one gather per column on the device, cut into batches."""
        sel = idx[start:start + m * bsz]
        rows = {k: torch.index_select(v, 0, sel) for k, v in cols.items()}
        return [{k: v[i * bsz:(i + 1) * bsz] for k, v in rows.items()}
                for i in range(m)]

    def fit_device_resident(
            self, state: TrainState, pipe, *,
            hooks: Optional[List[Callable]] = None,
            max_steps: Optional[int] = None,
            on_log: Optional[Callable[[int, float, float], None]] = None,
            guard: Optional[guard_lib.NonFiniteGuard] = None
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Train with the whole decoded dataset on the device.

        Callers clear :meth:`device_dataset_ineligible` first. ``fit``'s
        contract: the pooled pipeline's dispatch grouping (k-step groups,
        then single batches, then the short remainder unless
        ``drop_remainder``), its hooks, log and meter cadence, its guard
        (a skipped dispatch's rows are consumed all the same) and its
        return dict. Each epoch uploads its row order (4 bytes a record);
        each dispatch sends nothing but its cursor."""
        cfg = self.cfg
        k = max(cfg.steps_per_loop, 1)
        bs = pipe.batch_size
        n = pipe.decoded_epoch_columns().num_records
        dev_cols = self._dd_upload(pipe)
        remaining = max_steps
        meter = prof_lib.ThroughputMeter()
        last_loss = float("nan")
        t0 = time.time()
        examples_since_log = 0
        n_steps = 0
        m: Dict[str, Any] = {}
        health = getattr(pipe, "health", None)
        guard_active = guard is not None and guard.per_dispatch
        snapshot = StateSnapshot() if guard_active else None
        watchdog = self._make_watchdog(guard, health)
        try:
            for e in range(pipe.num_epochs):
                if remaining is not None and remaining <= 0:
                    break
                epoch = e + getattr(pipe, "epoch_offset", 0)
                idx = torch.from_numpy(pipe.device_epoch_indices(epoch, k)
                                       ).to(self.device)
                # The pooled pipeline's emission for one epoch, as sizes.
                n_batches = n // bs
                r = n - n_batches * bs
                sizes = [bs] * n_batches
                if r and not pipe.drop_remainder:
                    sizes.append(r)
                if remaining is not None:
                    sizes = sizes[:remaining]
                    remaining -= len(sizes)
                start = 0
                i = 0
                while i < len(sizes):
                    if (sizes[i] == bs and i + k <= len(sizes)
                            and sizes[i + k - 1] == bs):
                        mm, bsz = k, bs
                    else:
                        mm, bsz = 1, sizes[i]
                    if guard_active:
                        snapshot.take(state)
                        prev_m = m
                    with trace_lib.span("train.dispatch", steps=mm,
                                        examples=mm * bsz):
                        group = self._dd_batches(dev_cols, idx, start, mm,
                                                 bsz)
                        if mm == 1:
                            state, m = self.train_step(state, group[0])
                        else:
                            state, m = self.multi_step(state, group)
                    # The rows are consumed whether or not the update
                    # survives the guard.
                    start += mm * bsz
                    i += mm
                    if guard_active:
                        verdict = self._guard_verdict(guard, state, m)
                        if verdict == "skip":
                            state, m = snapshot.restore(state), prev_m
                            if watchdog is not None:
                                watchdog.beat(n_steps)
                            continue
                        if verdict == "rollback":
                            raise guard_lib.RollbackSignal(int(state.step))
                    prev_steps = n_steps
                    n_steps += mm
                    examples_since_log += mm * bsz
                    meter.update(mm * bsz, mm)
                    if watchdog is not None:
                        watchdog.beat(n_steps)
                    if cfg.log_steps and (n_steps // cfg.log_steps
                                          > prev_steps // cfg.log_steps):
                        loss = float(m["loss"])
                        last_loss = loss
                        if guard is not None and not guard_active:
                            guard.observe(loss, state.step, params_bad=(
                                guard.params_nonfinite(state.params)
                                if math.isfinite(loss) else False))
                        eps = examples_since_log / max(time.time() - t0,
                                                       1e-9)
                        log.info("step=%d loss=%.5f examples/sec=%.0f",
                                 state.step, loss, eps)
                        if health is not None and health.consume_dirty():
                            log.info("data health: %s", health.summary())
                        if on_log is not None:
                            on_log(state.step, loss, eps)
                        t0 = time.time()
                        examples_since_log = 0
                    if hooks:
                        m = {**m, "steps_done": mm}
                        for hook in hooks:
                            hook(state, m)
        finally:
            if watchdog is not None:
                watchdog.stop()
        if n_steps:
            self._sync()
            meter.record_drain()
            if math.isnan(last_loss):
                last_loss = float(m["loss"])
        out = {"loss": last_loss, "steps": float(n_steps)}
        out.update({k_: v for k_, v in meter.summary().items()
                    if k_ != "steps"})
        return state, out

    # ------------------------------------------------------------------
    # Eval / predict
    # ------------------------------------------------------------------
    def evaluate(self, state: TrainState,
                 batches: Iterable[Batch]) -> Dict[str, float]:
        """Streaming eval: binned AUC + mean loss. Every batch is padded to
        ``batch_size`` with zero-weight rows, so no record is dropped and
        none counts twice."""
        if self._tier is not None:
            # The ordinary dense forward over the full tables (flushed hot
            # rows + cold store).
            state = self._tier.densified(state)
        cfg = self.cfg
        auc_state = metrics_lib.auc_init(cfg.auc_num_thresholds,
                                         device=self.device)
        loss_state = metrics_lib.mean_init(device=self.device)
        n = 0
        t_start = time.time()
        t_first = None
        with torch.no_grad():
            for batch in batches:
                dev = self.put_batch(_with_weight(batch, cfg.batch_size))
                logits = self._logits(state, dev, train=False)
                labels = dev["label"].reshape(-1).float()
                w = dev["weight"].reshape(-1)
                per_ex = self._per_example_loss(logits, labels)
                auc_state = metrics_lib.auc_update(
                    auc_state, torch.sigmoid(logits), labels, w)
                loss_state = metrics_lib.MeanState(
                    total=loss_state.total + torch.sum(per_ex * w),
                    count=loss_state.count + torch.sum(w))
                n += 1
                if t_first is None:
                    t_first = time.time()
        if n == 0:
            return {"auc": 0.0, "loss": 0.0, "batches": 0.0,
                    "examples_per_sec": 0.0, "examples_per_sec_steady": 0.0}
        auc = float(metrics_lib.auc_compute(auc_state))  # device sync
        n_examples = float(loss_state.count)
        elapsed = max(time.time() - t_start, 1e-9)
        raw_eps = n_examples / elapsed
        # Steady rate: the first batch (kernel build, allocator growth) is
        # left out of both the window and the count.
        steady_window = elapsed - (t_first - t_start)
        steady_eps = (n_examples * (n - 1) / n / steady_window
                      if n > 1 and steady_window > 1e-9 else raw_eps)
        return {"auc": auc,
                "loss": float(metrics_lib.mean_compute(loss_state)),
                "batches": float(n), "examples_per_sec": raw_eps,
                "examples_per_sec_steady": steady_eps}

    def predict(self, state: TrainState,
                batches: Iterable[Batch]) -> Iterator[np.ndarray]:
        """Yield one probability vector per batch."""
        if self._tier is not None:
            state = self._tier.densified(state)
        with torch.no_grad():
            for batch in batches:
                logits = self._logits(state, self.put_batch(batch),
                                      train=False)
                yield torch.sigmoid(logits).cpu().numpy()


def _groups(batches: Iterable[Batch], k: int) -> Iterator[List[Batch]]:
    """Full groups of ``k`` batches, then the tail one batch at a time."""
    group: List[Batch] = []
    for b in batches:
        group.append(b)
        if len(group) == k:
            yield group
            group = []
    for b in group:
        yield [b]
