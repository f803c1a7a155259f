"""Retrieve→rank cascade serving: one artifact, two stages, one hot swap
(port of ``deepfm_tpu.rec.cascade``).

A published artifact dir carries three servables:

  * the ranker (``export_serving``'s ``params.pt`` + ``model_config.json``,
    history-aware through the packed-column signature),
  * the twin towers (``towers.npz`` + ``towers_config.json``),
  * the candidate index (``index.npz`` + ``index_meta.json``, recall@k
    stamped).

``export_cascade`` writes the retrieval files first and lets
``export_serving`` finish the dir, so its ``ARTIFACT_COMPLETE`` marker
certifies all three stages at once. :class:`CascadeEngine` serves them end
to end: user history → user tower → index top-N → packed ranking batch
through a :class:`~deepfm_tpu_torch.serve.engine.ServingEngine` → top-k.
The hot swap is atomic across stages: one ``LatestWatcher`` loads ranker,
towers and index off to the side as a single :class:`CascadeModel` and
swaps the composite with one assignment, so no request ever ranks new
candidates with an old ranker or the other way round.

``fused=True`` serves a fusable artifact (``CascadeModel.supports_fused``:
a ranker with ``raw_call``, a ``brute`` index, one output) through one
device program per shape instead: user tower, top-k, candidate
substitution, history fit and ranker on the card with no host copy between
stages, then one copy of the ``[B, N]`` logits and candidate ids and the
staged path's own host sigmoid and stable argsort, so a single user's
answer equals the staged answer bit for bit. Unlike the JAX package, a
failure inside the fused program raises: it never falls back to the staged
path (``fused_failed`` stays False); an artifact that cannot fuse is
served staged, decided before any work.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data import fileio
from ..models.twin_tower import TwinTower
from ..obs import trace as trace_lib
from ..serve.admission import (DEGRADE_RUNGS, VALUE_DEFAULT,
                               DegradationLadder)
from ..serve.cache import ResultCache, request_fingerprint
from ..serve.engine import ServingEngine
from ..serve.stats import ServingStats
from ..utils import device as device_lib
from ..utils import export as export_lib
from .index import CandidateIndex

TOWERS_FILE = "towers.npz"
TOWERS_CONFIG_FILE = "towers_config.json"

#: which feature field holds the candidate item id (the cascade convention
#: shared with ``train_twin_tower``'s positive extraction)
ITEM_SLOT = 0


def _leaf_order(names) -> List[str]:
    """State names in the JAX package's ``tree_flatten`` order of the same
    tree: dict keys sorted as strings (``t0, t1, t10, ..., t2``), list
    indices in numeric order. ``towers.npz`` stores leaves in this order;
    the order, not the names, is the file's contract."""
    return sorted(names, key=lambda n: [int(p) if p.isdigit() else p
                                        for p in n.split(".")])


def save_towers(tower: TwinTower, cfg: Config, out_dir: str) -> None:
    """``towers.npz`` (leaves ``p0, p1, ...`` in tree-flatten order) + the
    config needed to rebuild the same tree at load time: the JAX package's
    files, readable by its ``load_towers``."""
    state = {k: v.detach().cpu().numpy() for k, v in tower.state_dict().items()}
    fileio.makedirs(out_dir)
    np.savez_compressed(os.path.join(out_dir, TOWERS_FILE),
                        **{f"p{i}": state[name] for i, name in
                           enumerate(_leaf_order(state))})
    with open(os.path.join(out_dir, TOWERS_CONFIG_FILE), "w") as f:
        json.dump({"config": cfg.to_dict()}, f, indent=2)


def load_towers(in_dir: str, *, device="cuda") -> TwinTower:
    """The :class:`TwinTower` of :func:`save_towers` output (the port's or
    the JAX package's) on ``device``: the module is rebuilt from the stored
    config and its state names, in tree-flatten order, take the stored
    leaves."""
    with open(os.path.join(in_dir, TOWERS_CONFIG_FILE)) as f:
        cfg = Config.from_dict(json.load(f)["config"])
    dev = device_lib.resolve(device)
    model = TwinTower(cfg, device="meta")
    names = _leaf_order(model.state_dict())
    data = np.load(os.path.join(in_dir, TOWERS_FILE))
    if len(data.files) != len(names):
        raise ValueError(
            f"{TOWERS_FILE} holds {len(data.files)} leaves; a twin tower "
            f"of this config has {len(names)}")
    model.load_state_dict({name: torch.from_numpy(data[f"p{i}"]).to(dev)
                           for i, name in enumerate(names)}, assign=True)
    return model.eval()


def export_cascade(ranker: torch.nn.Module, cfg: Config, out_dir: str, *,
                   tower: TwinTower, index: CandidateIndex,
                   index_meta: Optional[Dict] = None, step: int = 0) -> str:
    """Write a complete cascade artifact: towers + index, THEN the ranker
    export (which writes ``ARTIFACT_COMPLETE`` last: the marker certifies
    every stage). ``index_meta`` carries measured stamps (recall@k)."""
    fileio.makedirs(out_dir)
    save_towers(tower, cfg, out_dir)
    index.save(out_dir, extra_meta=index_meta)
    return export_lib.export_serving(ranker, cfg, out_dir, step=step)


def cascade_extra_export(cfg: Config, tower: TwinTower,
                         index: CandidateIndex, *,
                         index_meta: Optional[Dict] = None
                         ) -> Callable[[str], None]:
    """``Publisher(extra_export=...)`` hook: stamps the frozen retrieval
    stage into every published ranker version (online training republishes
    the ranker continuously; retraining towers/index is a batch job)."""
    def hook(staging_dir: str) -> None:
        save_towers(tower, cfg, staging_dir)
        index.save(staging_dir, extra_meta=index_meta)
    return hook


class CascadeModel:
    """ONE loaded artifact version: ranker + towers + index, swap-atomic,
    on ``device``.

    Callable with the engine's ``(feat_ids, feat_vals)`` signature (ranking
    only, packed columns), and carries the retrieval stage alongside so a
    single reference assignment swaps both. ``buckets`` are the serving
    engine's: the ranker's bucket ladder, and the row buckets of the fused
    program."""

    #: a failure inside the fused program raises; it never marks the
    #: model for a staged fallback (kept for the JAX package's interface)
    fused_failed = False

    def __init__(self, path: str, *, buckets: Sequence[int], device="cuda"):
        self.path = path
        self.device = device_lib.resolve(device)
        self.rank_fn = export_lib.load_serving(path, buckets=buckets,
                                               device=self.device)
        meta = json.loads(fileio.read_bytes(
            fileio.join(path, "model_config.json")).decode("utf-8"))
        self.field_size = int(meta["config"]["field_size"])
        self.hist_len = int(meta.get("history_len", 0))
        self.outputs = tuple(meta["signature"]["outputs"])
        self.tower = load_towers(path, device=self.device)
        self.index, self.index_meta = CandidateIndex.load(path,
                                                          device=self.device)
        self._row_buckets = tuple(sorted(int(b) for b in buckets))
        # Fused program cache: one program per (batch_bucket, seq_len,
        # retrieve_k, k). Living on the MODEL means a hot swap drops every
        # stale program with the old version for free.
        self._fused_cache: Dict[Tuple[int, int, int, int], Callable] = {}

    # engine-facing predict: delegate, keep prewarm metadata visible
    def __call__(self, feat_ids, feat_vals):
        return self.rank_fn(feat_ids, feat_vals)

    @property
    def buckets(self):
        return getattr(self.rank_fn, "buckets", None)

    @property
    def input_cols(self):
        return getattr(self.rank_fn, "input_cols", None)

    def _put(self, x: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(
            self.device)

    def user_embed(self, hist_ids: np.ndarray,
                   hist_mask: np.ndarray) -> np.ndarray:
        """[B, L] history (numpy) -> [B, D] float32 user vectors (numpy)."""
        with torch.inference_mode():
            return self.tower.user_embed(
                self._put(hist_ids, np.int32),
                self._put(hist_mask, np.float32)).cpu().numpy()

    # ------------------------------------------------------ fused program
    @property
    def supports_fused(self) -> bool:
        """Whether :meth:`fused_program` can serve this artifact: a ranker
        with ``raw_call`` (``load_serving`` attaches it), a ``brute`` index
        (the ANN's partition scan runs on the host) and one output
        (``model_config.json``'s signature; a multi-task artifact serves
        staged)."""
        return (getattr(self.rank_fn, "raw_call", None) is not None
                and self.index.kind == "brute"
                and len(self.outputs) == 1)

    def fused_program(self, batch: int, seq_len: int, retrieve_k: int,
                      k: int) -> Callable:
        """The per-request cascade at this shape as ONE device program:
        user tower -> brute top-k (``CandidateIndex.topk_rows``, the staged
        search) -> candidate substitution into ``ITEM_SLOT`` -> history fit
        (the most recent tail, zero-padded) -> ``raw_call``, with no host
        copy between stages; then one copy of the ``[B, N]`` logits and
        candidate ids, and the staged path's ``host_sigmoid`` and stable
        argsort on the host. The ranker sees ``B * N`` rows padded with
        zero rows to the engine's bucket (as the staged flush pads them) up
        to its largest bucket. Built once per shape key and cached on this
        model version; refuses an artifact that cannot fuse."""
        if not self.supports_fused:
            raise ValueError(
                f"{self.path}: the fused cascade needs a ranker with "
                "raw_call, a brute index and one output; serve it staged")
        key = (int(batch), int(seq_len), int(retrieve_k), int(k))
        fn = self._fused_cache.get(key)
        if fn is not None:
            return fn
        raw = self.rank_fn.raw_call
        b, ln, n, kk = key
        field, hist_len = self.field_size, self.hist_len
        width = field + hist_len
        fit = min(ln, hist_len)
        rows = b * n
        padded = (export_lib.next_bucket(rows, self._row_buckets)
                  if rows <= self._row_buckets[-1] else rows)
        dev = self.device

        def prog(hist_ids, hist_mask, feat_ids, feat_vals):
            h_ids = self._put(hist_ids, np.int32)
            h_mask = self._put(hist_mask, np.float32)
            f_ids = self._put(feat_ids, np.int32)
            f_vals = self._put(feat_vals, np.float32)
            with torch.inference_mode():
                users = self.tower.user_embed(h_ids, h_mask)      # [B, D]
                _, cand_rows = self.index.topk_rows(users, n)     # [B, N]
                cands = self.index.ids_on_device[cand_rows]
                ids = torch.zeros((padded, width), dtype=torch.int32,
                                  device=dev)
                vals = torch.zeros((padded, width), dtype=torch.float32,
                                   device=dev)
                ids3 = ids[:rows].view(b, n, width)
                vals3 = vals[:rows].view(b, n, width)
                ids3[:, :, :field] = f_ids[:, None, :]
                vals3[:, :, :field] = f_vals[:, None, :]
                ids3[:, :, ITEM_SLOT] = cands.to(torch.int32)
                if hist_len:
                    ids3[:, :, field:field + fit] = h_ids[:, None, ln - fit:]
                    vals3[:, :, field:field + fit] = \
                        h_mask[:, None, ln - fit:]
                logits = raw(ids, vals)[:rows].reshape(b, n)
            probs = export_lib.host_sigmoid(logits.float().cpu().numpy())
            cands_h = cands.cpu().numpy()
            top = np.argsort(-probs, axis=1, kind="stable")[:, :kk]
            return (np.take_along_axis(cands_h, top, axis=1),
                    np.take_along_axis(probs, top, axis=1))

        self._fused_cache[key] = prog
        return prog


class CascadeEngine:
    """Two-stage serving over the publish/hot-swap machinery, on
    ``device``.

    ``recommend(hist_ids, hist_mask, feat_ids, feat_vals, k)``:

      1. the user tower embeds the history;
      2. the candidate index retrieves ``retrieve_k`` item ids;
      3. each candidate is substituted into the request's item slot
         (field ``ITEM_SLOT``), history packed alongside, and the batch
         ranked through the inner :class:`ServingEngine` (dynamic batching
         + bucketed shapes + backpressure all apply);
      4. the top ``k`` candidates by ranker probability come back.

    An empty history is legal end-to-end: the user tower pools zeros (the
    index then returns ITS notion of head items) and the ranker's attention
    contributes exact zeros — finite probabilities, never NaN.

    **Overload plane.** ``slo_ms``/``shed_watermark`` build an
    :class:`~deepfm_tpu_torch.serve.admission.AdmissionController` for the
    inner ranking engine (low-value requests get a typed ``AdmissionShed``).
    ``degrade_retrieve_k`` > 0 additionally arms the graceful-degradation
    ladder: under pressure ``recommend`` first shrinks the candidate set to
    ``degrade_retrieve_k`` (rung ``reduced_retrieve``), then skips the
    ranker entirely and answers in retrieval order (rung
    ``retrieval_only`` — scores are the index's inner-product scores, NOT
    calibrated probabilities). Every rung change is a counted, span-traced
    transition; per-request degradation is counted per rung.

    **Fused path.** ``fused=True`` serves full-cascade requests of a
    fusable artifact through :meth:`CascadeModel.fused_program`; any other
    artifact (an ANN index, a multi-task ranker) serves staged. A failure
    inside the fused program raises to the caller.
    """

    def __init__(self, publish_dir: str, *, retrieve_k: int = 50,
                 poll_secs: float = 2.0, max_batch: int = 256,
                 max_delay_ms: float = 5.0,
                 buckets: Optional[Sequence[int]] = None,
                 queue_rows: int = 0,
                 slo_ms: float = 0.0, shed_watermark: int = 0,
                 degrade_retrieve_k: int = 0,
                 fused: bool = False,
                 user_cache_rows: int = 0,
                 cache_rows: int = 0, cache_ttl_s: float = 0.0,
                 coalesce: bool = False,
                 watcher_kw: Optional[dict] = None,
                 engine_kw: Optional[dict] = None,
                 device="cuda"):
        if retrieve_k < 1:
            raise ValueError("retrieve_k must be >= 1")
        if degrade_retrieve_k < 0 or degrade_retrieve_k > retrieve_k:
            raise ValueError(
                f"degrade_retrieve_k must be in 0..retrieve_k="
                f"{retrieve_k}, got {degrade_retrieve_k}")
        if user_cache_rows < 0:
            raise ValueError(
                f"user_cache_rows must be >= 0, got {user_cache_rows}")
        self.retrieve_k = int(retrieve_k)
        self.degrade_retrieve_k = int(degrade_retrieve_k)
        dev = device_lib.resolve(device)
        resolved = tuple(sorted({int(b) for b in (
            buckets if buckets is not None
            else export_lib.serving_buckets(max_batch))} | {int(max_batch)}))
        stats = ServingStats()
        wkw = {"poll_secs": poll_secs}
        wkw.update(watcher_kw or {})  # caller overrides (tests drive polls)
        self._watcher = export_lib.LatestWatcher(
            publish_dir,
            loader=lambda path: CascadeModel(path, buckets=resolved,
                                             device=dev),
            on_swap=lambda path: stats.record_swap(),
            **wkw)
        ekw = dict(engine_kw or {})
        if (slo_ms > 0 or shed_watermark > 0) \
                and "admission" not in ekw and "admission_kw" not in ekw:
            ekw["admission_kw"] = {"slo_ms": slo_ms,
                                   "shed_watermark": shed_watermark}
        # Fast-path levers forward to the inner ranking engine: the result
        # cache there caches whole ranking batches under the same
        # (version, fingerprint) law as standalone serving.
        ekw.setdefault("cache_rows", cache_rows)
        ekw.setdefault("cache_ttl_s", cache_ttl_s)
        ekw.setdefault("coalesce", coalesce)
        self._engine = ServingEngine(
            self._watcher, max_batch=max_batch, max_delay_ms=max_delay_ms,
            buckets=resolved, queue_rows=queue_rows, stats=stats, **ekw)
        # Fused device program (opt-in, per-model gate) + the per-user
        # tower-embedding cache.
        self.fused = bool(fused)
        self._fused_buckets = resolved
        self.fused_calls = 0
        self._user_cache = ResultCache(user_cache_rows) \
            if user_cache_rows > 0 else None
        self.user_cache_hits = 0
        self.user_cache_misses = 0
        self._fast_lock = threading.Lock()
        stats.set_policy(serve_fused_cascade=self.fused,
                         serve_cache_user_rows=int(user_cache_rows))
        self._ladder: Optional[DegradationLadder] = None
        if self.degrade_retrieve_k > 0:
            self._ladder = DegradationLadder(stats=stats)
            # Without an admission gate the ladder still needs a pressure
            # scale: the same watermark default (half the queue).
            self._degrade_watermark = (
                self._engine.admission.shed_watermark
                if self._engine.admission is not None
                else max(1, int(shed_watermark)
                         or self._engine.queue_rows // 2))

    @property
    def watcher(self) -> export_lib.LatestWatcher:
        return self._watcher

    @property
    def engine(self) -> ServingEngine:
        return self._engine

    @property
    def stats(self) -> ServingStats:
        return self._engine.stats

    def current(self) -> CascadeModel:
        model = self._watcher._fn
        if model is None:
            raise RuntimeError("no cascade artifact published yet")
        return model

    # ----------------------------------------------------- degraded modes
    @property
    def ladder(self) -> Optional[DegradationLadder]:
        return self._ladder

    def _pressure(self) -> float:
        """The ladder's drive signal: the admission controller's combined
        depth+delay pressure when one is armed, raw queue depth over the
        degrade watermark otherwise."""
        pending = self._engine.pending_rows
        adm = self._engine.admission
        if adm is not None:
            return adm.pressure(pending)
        return pending / self._degrade_watermark

    def ladder_rung(self) -> int:
        """Advance the degradation ladder against CURRENT pressure and
        return the rung (0 = full cascade). Called per recommend(); also
        callable idle (a drill observes recovery after a chaos window
        drains)."""
        if self._ladder is None:
            return 0
        return self._ladder.update(self._pressure())

    # ------------------------------------------------------------- serving
    def _user_embed(self, model: CascadeModel, hist_ids: np.ndarray,
                    hist_mask: np.ndarray) -> np.ndarray:
        """User-tower embedding with the per-user cache in front: keyed
        ``(artifact path, fingerprint(history))`` so a hot swap — a new
        path — invalidates every cached embedding for free, exactly like
        the result cache's version key. Hits return bit-identical copies
        of the tower's output; a Zipf head user pays the tower once per
        artifact version instead of once per request."""
        if self._user_cache is None:
            return model.user_embed(hist_ids, hist_mask)
        fp = request_fingerprint(hist_ids, hist_mask)
        hit = self._user_cache.get(model.path, fp)
        if hit is not None:
            with self._fast_lock:
                self.user_cache_hits += 1
            trace_lib.instant("serve.cache", event="user_hit",
                              rows=int(hist_ids.shape[0]))
            return hit
        users = model.user_embed(hist_ids, hist_mask)
        self._user_cache.put(model.path, fp, users,
                             int(hist_ids.shape[0]))
        with self._fast_lock:
            self.user_cache_misses += 1
        return users

    def retrieve(self, hist_ids: np.ndarray, hist_mask: np.ndarray,
                 k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Retrieval stage only: (item_ids [B, k], scores [B, k])."""
        model = self.current()
        hist_ids = np.atleast_2d(np.asarray(hist_ids, np.int32))
        hist_mask = np.atleast_2d(np.asarray(hist_mask, np.float32))
        users = self._user_embed(model, hist_ids, hist_mask)
        return model.index.search(users, k or self.retrieve_k)

    def recommend(self, hist_ids: np.ndarray, hist_mask: np.ndarray,
                  feat_ids: np.ndarray, feat_vals: np.ndarray, *,
                  k: int = 10, timeout: Optional[float] = 30.0,
                  value: str = VALUE_DEFAULT
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """ONE user's end-to-end recommendation: (item_ids [k], probs [k]).

        ``hist_ids``/``hist_mask`` [L]; ``feat_ids``/``feat_vals`` [F] the
        request context (field ``ITEM_SLOT`` is overwritten per candidate).
        The SAME loaded model version serves both stages of this request
        even if a hot swap lands mid-flight. ``value`` is the admission
        value class of the inner ranking request.

        With the degradation ladder armed, an over-budget fleet answers
        degraded instead of failing: rung 1 ranks only
        ``degrade_retrieve_k`` candidates; rung 2 skips the ranker and the
        returned scores are RETRIEVAL scores (inner products), not
        probabilities — callers can tell from the counted, traced rung.
        """
        model = self.current()
        hist_ids = np.asarray(hist_ids, np.int32).reshape(1, -1)
        hist_mask = np.asarray(hist_mask, np.float32).reshape(1, -1)
        feat_ids = np.asarray(feat_ids, np.int32).reshape(-1)
        feat_vals = np.asarray(feat_vals, np.float32).reshape(-1)
        if feat_ids.shape[0] != model.field_size:
            raise ValueError(
                f"expected {model.field_size} context fields, "
                f"got {feat_ids.shape[0]}")
        rung = self.ladder_rung()
        if rung == 0 and self.fused and model.supports_fused:
            ids_k, probs_k = self._recommend_fused(
                model, hist_ids, hist_mask, feat_ids[None],
                feat_vals[None], k)
            return ids_k[0], probs_k[0]
        retrieve_k = self.retrieve_k if rung == 0 \
            else self.degrade_retrieve_k
        users = self._user_embed(model, hist_ids, hist_mask)
        cand_ids, cand_scores = model.index.search(users, retrieve_k)
        cand_ids = cand_ids[0]                              # [N]
        n = cand_ids.shape[0]
        if rung > 0:
            self.stats.record_degraded(DEGRADE_RUNGS[rung])
        if rung >= 2:
            # retrieval_only: serve the index's order — the request costs
            # one tower embed + one search, no ranking flush at all.
            k = min(int(k), n)
            return cand_ids[:k], cand_scores[0][:k]
        ids = np.tile(feat_ids, (n, 1)).astype(np.int32)    # [N, F]
        vals = np.tile(feat_vals, (n, 1)).astype(np.float32)
        ids[:, ITEM_SLOT] = cand_ids
        if model.hist_len:
            h_ids, h_mask = _fit_history(hist_ids[0], hist_mask[0],
                                         model.hist_len)
            ids = np.concatenate(
                [ids, np.tile(h_ids, (n, 1))], axis=1)
            vals = np.concatenate(
                [vals, np.tile(h_mask, (n, 1))], axis=1)
        probs = np.asarray(
            self._engine.predict(ids, vals, timeout=timeout,
                                 value=value)).reshape(-1)
        k = min(int(k), n)
        top = np.argsort(-probs, kind="stable")[:k]
        return cand_ids[top], probs[top]

    # ----------------------------------------------------- fused fast path
    def _recommend_fused(self, model: CascadeModel, hist_ids: np.ndarray,
                         hist_mask: np.ndarray, feat_ids: np.ndarray,
                         feat_vals: np.ndarray, k: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Run [B] users through the fused device program. The batch pads
        up to the engine's bucket ladder (pad users are all-zeros and
        sliced away), so at most ``len(buckets)`` programs build per
        (seq_len, retrieve_k, k). Completions are recorded into the SAME
        stats reservoirs as staged requests."""
        t0 = time.monotonic()
        b = int(hist_ids.shape[0])
        bucket = export_lib.next_bucket(b, self._fused_buckets)
        if bucket != b:
            def pad(x):
                return np.concatenate(
                    [x, np.zeros((bucket - b,) + x.shape[1:], x.dtype)])
            hist_ids, hist_mask = pad(hist_ids), pad(hist_mask)
            feat_ids, feat_vals = pad(feat_ids), pad(feat_vals)
        n = min(self.retrieve_k, model.index.num_items)
        kk = min(int(k), n)
        fn = model.fused_program(bucket, int(hist_ids.shape[1]), n, kk)
        top_ids, top_p = fn(hist_ids, hist_mask, feat_ids, feat_vals)
        lat_ms = 1000.0 * (time.monotonic() - t0)
        with self._fast_lock:
            self.fused_calls += 1
        for _ in range(b):
            self.stats.record_request_done(lat_ms)
        return top_ids[:b], top_p[:b]

    def recommend_batch(self, hist_ids: np.ndarray, hist_mask: np.ndarray,
                        feat_ids: np.ndarray, feat_vals: np.ndarray, *,
                        k: int = 10, timeout: Optional[float] = 30.0,
                        value: str = VALUE_DEFAULT
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """[B] users end-to-end at once: (item_ids [B, k], probs [B, k]).

        With the fused program armed (``fused=True`` and a fusable
        artifact, full-cascade rung) the whole batch is ONE device
        program; otherwise each row runs the staged path. Output is
        row-for-row what per-row :meth:`recommend` returns: the same items,
        probabilities to float ULP (a batch's GEMMs run at other shapes;
        one user through the fused path is bit-equal to staged)."""
        hist_ids = np.atleast_2d(np.asarray(hist_ids, np.int32))
        hist_mask = np.atleast_2d(np.asarray(hist_mask, np.float32))
        feat_ids = np.atleast_2d(np.asarray(feat_ids, np.int32))
        feat_vals = np.atleast_2d(np.asarray(feat_vals, np.float32))
        model = self.current()
        if self.fused and model.supports_fused and self.ladder_rung() == 0:
            return self._recommend_fused(model, hist_ids, hist_mask,
                                         feat_ids, feat_vals, k)
        out_ids, out_ps = [], []
        for i in range(hist_ids.shape[0]):
            ids_i, p_i = self.recommend(
                hist_ids[i], hist_mask[i], feat_ids[i], feat_vals[i],
                k=k, timeout=timeout, value=value)
            out_ids.append(ids_i)
            out_ps.append(p_i)
        return np.stack(out_ids), np.stack(out_ps)

    # ----------------------------------------------------------- lifecycle
    def close(self, timeout: Optional[float] = None) -> None:
        self._engine.close(timeout=timeout)
        self._watcher.close()

    def __enter__(self) -> "CascadeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fit_history(hist_ids: np.ndarray, hist_mask: np.ndarray,
                 hist_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate a request's history to the artifact's trained length
    (keep the most recent tail on truncation).

    Short-circuits: a history-free artifact (``hist_len`` 0) returns empty
    arrays immediately, and an already-fitting history is passed through
    without a re-fit copy."""
    hist_len = int(hist_len)
    if hist_len <= 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.float32)
    ln = hist_ids.shape[0]
    if ln == hist_len:
        return (np.asarray(hist_ids, np.int32),
                np.asarray(hist_mask, np.float32))
    out_ids = np.zeros((hist_len,), np.int32)
    out_mask = np.zeros((hist_len,), np.float32)
    n = min(ln, hist_len)
    out_ids[:n] = hist_ids[ln - n:]
    out_mask[:n] = hist_mask[ln - n:]
    return out_ids, out_mask
