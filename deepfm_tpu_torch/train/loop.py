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
calls; ``fit`` fires its hooks once per dispatch and reads the loss back to
the host only at the ``log_steps`` cadence, so the host stays ahead of the
card. Host batches go to the card through pinned memory with
``non_blocking`` copies made from the fit thread, while the pipeline's
prefetch thread decodes ahead.

With ``--embedding_tiering hot_cold`` (sparse update, monolithic table)
the tables and their lazy-Adam slots live in host RAM and only
``--embedding_hot_rows`` rows are on the device (``data.hot_cold``): ``fit``
plans each dispatch group ``--transfer_ahead`` groups early on a staging
thread (cold fetches and the id -> slot remap, numpy only), applies the
group's cache transaction on the fit thread just before its dispatch, and
``evaluate``/``predict`` run on the densified full tables.

Not ported yet, each raising ``NotImplementedError`` naming its flag:
gradient accumulation (dense or sparse), the device-resident dataset, a
mesh other than 1x1 and the stall watchdog. The JAX package's device
staging ring (``--staging_buffers``) has no counterpart, and without
tiering ``--transfer_ahead`` is not read: host batches go to the card from
the fit thread.
"""

from __future__ import annotations

import itertools
import logging
import math
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
from .state import TrainState

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
        (cfg.grad_accum_steps > 1,
         "--grad_accum_steps > 1 (gradient accumulation)"),
        (cfg.device_dataset, "--device_dataset (the device-resident dataset)"),
        (cfg.mesh_data > 1 or cfg.mesh_model > 1,
         f"--mesh_data {cfg.mesh_data} --mesh_model {cfg.mesh_model} (a mesh "
         "other than 1x1)"),
        (cfg.dispatch_timeout_s > 0,
         "--dispatch_timeout_s (the stall watchdog)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not yet ported to deepfm_tpu_torch")


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
        other out-of-range id adds nothing, as the JAX scatter does.

        ``index_add_`` sums in position order on the CPU, the JAX package's
        order, but with float atomics on the card, whose order (and so the
        last bits of a row's gradient) changes from run to run: the port's
        tests hold this leg to a tolerance on the card, and to the JAX
        package's band on the CPU."""
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
        gext = torch.zeros((rows + 1, gcat.shape[1]), dtype=torch.float32,
                           device=flat.device)
        return gext.index_add_(0, flat, gcat)[:rows]

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

    def multi_step(self, state: TrainState,
                   batches: List[Dict[str, torch.Tensor]]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """K optimizer steps in one dispatch; the last step's metrics."""
        m: Dict[str, torch.Tensor] = {}
        for batch in batches:
            state, m = self.train_step(state, batch)
        return state, m

    # ------------------------------------------------------------------
    # Fit
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, state: TrainState, batches: Iterable[Batch], *,
            hooks: Optional[List[Callable]] = None,
            max_steps: Optional[int] = None,
            on_log: Optional[Callable[[int, float, float], None]] = None,
            guard: Optional[guard_lib.NonFiniteGuard] = None
            ) -> Tuple[TrainState, Dict[str, float]]:
        """Train over an iterable of host batches.

        Groups ``cfg.steps_per_loop`` batches per dispatch (a shorter tail
        runs one step per dispatch, as the JAX package stages it); hooks
        fire once per dispatch with ``m["steps_done"]``. The loss is read
        back only when a dispatch crosses a ``log_steps`` boundary, where
        ``guard`` (the abort policy) also looks at it."""
        cfg = self.cfg
        k = max(cfg.steps_per_loop, 1)
        if max_steps is not None:
            batches = itertools.islice(iter(batches), max_steps)
        tier = self._tier
        if tier is not None:
            groups = self._stage_tiered(batches, k, cfg.transfer_ahead,
                                        tier.start_staging())
        else:
            groups = ((g, sum(int(b["label"].shape[0]) for b in g))
                      for g in _groups(batches, k))
        last_loss = float("nan")
        n_steps = 0
        examples_since_log = 0
        m: Dict[str, Any] = {}
        meter = prof_lib.ThroughputMeter()
        t0 = time.time()
        try:
            for group, n_ex in groups:
                if tier is not None:
                    # This dispatch's cache transaction goes first, on the
                    # stream its step is enqueued on.
                    state = tier.apply_next(state)
                with trace_lib.span("train.dispatch", steps=len(group),
                                    examples=n_ex):
                    dev = [self.put_batch(b) for b in group]
                    if len(dev) == 1:
                        state, m = self.train_step(state, dev[0])
                    else:
                        state, m = self.multi_step(state, dev)
                prev_steps = n_steps
                n_steps += len(group)
                examples_since_log += n_ex
                meter.update(n_ex, len(group))
                if cfg.log_steps and (n_steps // cfg.log_steps
                                      > prev_steps // cfg.log_steps):
                    loss = float(m["loss"])  # device sync, bounded by cadence
                    last_loss = loss
                    if guard is not None:
                        guard.observe(loss, state.step, params_bad=(
                            guard.params_nonfinite(state.params)
                            if math.isfinite(loss) else False))
                    eps = examples_since_log / max(time.time() - t0, 1e-9)
                    log.info("step=%d loss=%.5f examples/sec=%.0f",
                             state.step, loss, eps)
                    if on_log is not None:
                        on_log(state.step, loss, eps)
                    t0 = time.time()
                    examples_since_log = 0
                if hooks:
                    m = {**m, "steps_done": len(group)}
                    for hook in hooks:
                        hook(state, m)
        finally:
            if tier is not None:
                # An abandoned fit stops its staging thread and applies the
                # plans it had queued, so no pin stays held and no thread
                # waits on them.
                groups.close()
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
        if tier is not None:
            out.update({f"hotcold_{k_}": float(v)
                        for k_, v in tier.stats.items()})
            out["hotcold_hit_rate"] = tier.hit_rate()
            out["hotcold_overlap_fraction"] = tier.overlap_fraction()
        return state, out

    def _stage_tiered(self, batches: Iterable[Batch], k: int, depth: int,
                      generation: int) -> Iterator[Tuple[List[Batch], int]]:
        """(group with slot ids, examples) per dispatch, in dispatch order:
        the groups of ``_groups``, each planned by the hot/cold runtime
        (victims, cold fetches, id -> slot remap) ``depth`` groups ahead on
        a staging thread (inline when ``depth`` is 0). Numpy work only; the
        fit thread applies one plan per group it takes."""
        tier = self._tier

        def gen():
            for group in _groups(batches, k):
                n_ex = sum(int(b["label"].shape[0]) for b in group)
                yield tier.plan_group(group, generation=generation), n_ex

        if depth <= 0:
            return gen()
        return pipe_lib.prefetch(gen(), depth)

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
