"""Serving export for the port (the serving subset of
``deepfm_tpu.utils.export``).

A servable artifact is a directory holding:
  * ``params.pt`` — the model's ``state_dict`` as one flat
    ``{name: tensor}`` dict, written with ``torch.save`` and read back with
    ``torch.load(weights_only=True)``;
  * ``model_config.json`` — the model hyperparameters and the signature
    schema, the same schema as the JAX package writes;
  * ``ARTIFACT_COMPLETE`` — written last, atomically: a directory without
    it is incomplete and refuses to load.

``load_serving`` rebuilds the model from the config, loads the weights onto
``device`` and returns ``f(feat_ids, feat_vals) -> probs``: numpy in, the
forward under ``torch.inference_mode()``, sigmoid, numpy out. A multi-task
artifact serves named outputs ``{task: probs}`` in task order; a sequence
model's artifact takes packed inputs ``field_size + history_len`` wide
(ids ``feat_ids || hist_ids``, vals ``feat_vals || hist_mask``), split
before the forward, so buckets, ``padded_predict`` and the engine serve
it unchanged. The result also carries ``raw_call(ids, vals) -> logits``,
the same forward on device tensors with no host copy (the fused
cascade's ranker, ``rec.cascade``).

Every file goes through ``data.fileio``, so an artifact dir may be local
or on a remote store (``gs://`` and the like). StableHLO and the TF
SavedModel sidecar are not part of the port.
"""

from __future__ import annotations

import io
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data import fileio
from . import device as device_lib

log = logging.getLogger(__name__)

_PARAMS_FILE = "params.pt"
_CONFIG_FILE = "model_config.json"

# Written LAST by export_serving: its presence certifies every other file in
# the artifact dir is complete.
COMPLETE_MARKER = "ARTIFACT_COMPLETE"

# Pointer file next to published artifact dirs: its content is the basename
# of the newest complete artifact, replaced atomically.
LATEST_FILE = "LATEST"


class ArtifactIncomplete(RuntimeError):
    """A servable artifact dir is missing its completion marker (export
    crashed mid-write, or the caller raced an in-flight publish)."""


def _task_names(model) -> Tuple[str, ...]:
    return tuple(getattr(model, "task_names", ()) or ())


def _serving_hist_len(model, cfg: Config) -> int:
    """History columns of the serving signature: > 0 only for a sequence
    model exported from a config with history."""
    if getattr(model, "uses_history", False) and cfg.history_max_len > 0:
        return int(cfg.history_max_len)
    return 0


def serving_input_cols(model, cfg: Config) -> int:
    """Width of the artifact's feat_ids/feat_vals inputs: ``field_size``,
    plus ``history_max_len`` packed history columns for a sequence
    model."""
    return cfg.field_size + _serving_hist_len(model, cfg)


def export_serving(model: torch.nn.Module, cfg: Config, out_dir: str, *,
                   step: int = 0) -> str:
    """Write the servable artifact of ``model``; returns the artifact path."""
    fileio.makedirs(out_dir)

    # 1. Weights: one flat {name: tensor} dict, on the CPU, so any device
    # can load it; serialized in memory and written in one write (a remote
    # stream cannot seek).
    flat = {k: v.detach().cpu().contiguous()
            for k, v in model.state_dict().items()}
    buf = io.BytesIO()
    torch.save(flat, buf)
    with fileio.open_stream(fileio.join(out_dir, _PARAMS_FILE), "wb") as f:
        f.write(buf.getbuffer())

    # 2. Signature/config metadata (the JAX package's schema). A multi-task
    # artifact names one output per task; a sequence model's inputs are
    # field_size + history_len wide.
    in_cols = serving_input_cols(model, cfg)
    names = _task_names(model)
    outputs = ({name: ["batch", "float32"] for name in names}
               if len(names) > 1 else {"prob": ["batch", "float32"]})
    meta = {
        "signature": {
            "inputs": {
                "feat_ids": ["batch", in_cols, "int32"],
                "feat_vals": ["batch", in_cols, "float32"],
            },
            "outputs": outputs,
        },
        "model": cfg.model,
        "history_len": _serving_hist_len(model, cfg),
        "config": cfg.to_dict(),
        "step": int(step),
    }
    fileio.write_atomic(fileio.join(out_dir, _CONFIG_FILE),
                        json.dumps(meta, indent=2))

    # 3. Completion marker — strictly last, atomically.
    fileio.write_atomic(fileio.join(out_dir, COMPLETE_MARKER),
                        json.dumps({"step": meta["step"]}))
    log.info("exported servable model to %s", out_dir)
    return out_dir


# --------------------------------------------------------------------------
# Bucketed prediction: the explicit per-shape cache
# --------------------------------------------------------------------------
#
# Every call pads to the next bucket size, so at most ``len(buckets)``
# batch shapes ever reach the model, and which sizes run is a deployment
# decision instead of an accident of traffic.

def serving_buckets(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two bucket ladder ``(1, 2, 4, ..., max_batch)``.

    ``max_batch`` itself is always the last bucket, even when it is not a
    power of two — the engine's largest flush must have a home.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b <<= 1
    buckets.append(int(max_batch))
    return tuple(buckets)


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= ``n`` (buckets ascending)."""
    if n < 1:
        raise ValueError(f"batch of {n} rows cannot be bucketed")
    for b in buckets:
        if b >= n:
            return int(b)
    raise ValueError(
        f"batch of {n} rows exceeds the largest bucket ({buckets[-1]}); "
        "raise serve_max_batch or split the request")


def padded_predict(fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                   feat_ids: np.ndarray, feat_vals: np.ndarray,
                   buckets: Sequence[int]) -> np.ndarray:
    """Run ``fn`` on the batch padded up to its bucket; return the real rows.

    Pad rows are zeros (id 0 is a valid embedding row; the serve path runs
    in eval mode so no batch statistic couples rows) and their outputs are
    sliced away before returning.
    """
    n = int(feat_ids.shape[0])
    b = next_bucket(n, buckets)
    if b == n:
        out = fn(feat_ids, feat_vals)
        if isinstance(out, dict):  # multitask: {task: probs}
            return {k: np.asarray(v) for k, v in out.items()}
        return np.asarray(out)
    ids = np.zeros((b,) + feat_ids.shape[1:], feat_ids.dtype)
    vals = np.zeros((b,) + feat_vals.shape[1:], feat_vals.dtype)
    ids[:n] = feat_ids
    vals[:n] = feat_vals
    out = fn(ids, vals)
    if isinstance(out, dict):
        return {k: np.asarray(v)[:n] for k, v in out.items()}
    return np.asarray(out)[:n]


class BucketedPredict:
    """``load_serving``-shaped callable with the bounded shape cache.

    Wraps a raw ``f(feat_ids, feat_vals) -> probs`` so only bucket shapes
    ever reach it. ``calls_per_bucket`` is observability for the serving
    stats (which bucket a deployment actually exercises).
    """

    def __init__(self, fn: Callable, buckets: Sequence[int]):
        bs = tuple(sorted({int(b) for b in buckets}))
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.fn = fn
        self.buckets = bs
        self.calls_per_bucket: Dict[int, int] = {b: 0 for b in bs}

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def __call__(self, feat_ids: np.ndarray,
                 feat_vals: np.ndarray) -> np.ndarray:
        self.calls_per_bucket[next_bucket(len(feat_ids), self.buckets)] += 1
        return padded_predict(self.fn, feat_ids, feat_vals, self.buckets)


def load_model(artifact_dir: str, *, device="cuda",
               **overrides: Any) -> Tuple[torch.nn.Module, Config, dict]:
    """Rebuild an artifact's model on ``device``, weights loaded, in eval
    mode. ``overrides`` replace config fields (``use_pallas=False`` gives
    the plain forward over the same weights). Returns (model, cfg, meta).

    Raises :class:`ArtifactIncomplete` when the dir lacks its completion
    marker."""
    if not fileio.exists(fileio.join(artifact_dir, COMPLETE_MARKER)):
        raise ArtifactIncomplete(
            f"{artifact_dir} has no {COMPLETE_MARKER} marker — the artifact "
            "is incomplete (crashed or in-flight export); refusing to load")
    dev = device_lib.resolve(device)
    meta = json.loads(fileio.read_bytes(
        fileio.join(artifact_dir, _CONFIG_FILE)).decode("utf-8"))
    cfg = Config.from_dict({**meta["config"], **overrides})
    weights = torch.load(
        io.BytesIO(fileio.read_bytes(fileio.join(artifact_dir, _PARAMS_FILE))),
        map_location=dev, weights_only=True)
    from ..models import get_model  # noqa: PLC0415 (models import this package)
    model = get_model(cfg, device="meta")
    model.load_state_dict(weights, assign=True)
    return model.eval(), cfg, meta


def host_sigmoid(logits: np.ndarray) -> np.ndarray:
    """The served probabilities: a float32 sigmoid on the host, element by
    element the same whatever the array's size. (``torch.sigmoid`` on the
    CPU takes a vectorized loop for whole chunks and a scalar one for the
    rest, which round differently, so a padded bucket's real rows could
    differ from the unpadded call's in the last bit.)"""
    x = np.asarray(logits, np.float32)
    e = np.exp(-np.abs(x))
    one = np.float32(1.0)
    return np.where(x >= 0, one / (one + e), e / (one + e)).astype(np.float32)


def load_serving(artifact_dir: str, *,
                 buckets: Optional[Sequence[int]] = None, device="cuda"
                 ) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Reload a servable artifact as ``f(feat_ids, feat_vals) -> probs``.

    With ``buckets`` the result is a :class:`BucketedPredict` — every call
    pads to the next bucket size (the serving engine's shape policy).
    Either result carries ``raw_call(ids, vals) -> logits``: the same
    forward on device tensors, returning device logits (no host copy, no
    padding; the fused cascade calls it at its own bucket shapes).

    Raises :class:`ArtifactIncomplete` when the dir lacks its completion
    marker — the dir is mid-write, or an export crashed into it. Callers
    that poll (``watch_latest``) treat this as "try again later"; everything
    else should treat it as a corrupt deployment.
    """
    model, cfg, meta = load_model(artifact_dir, device=device)
    dev = model.fm_b.device
    names = _task_names(model)
    hist_len = int(meta.get("history_len", 0))
    fs = cfg.field_size

    def raw_call(ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """Device logits ([n], or [n, T] multi-task) of int32 ids and
        float32 vals already on the model's device, with no host copy: the
        forward every served call runs, and the fused cascade's ranker."""
        kw = {}
        if hist_len:
            # The packed columns: feat_ids || hist_ids, feat_vals ||
            # hist_mask (contiguous again: the FM kernel reads rows).
            kw = {"hist_ids": ids[:, fs:].contiguous(),
                  "hist_mask": vals[:, fs:].contiguous()}
            ids, vals = ids[:, :fs].contiguous(), vals[:, :fs].contiguous()
        with torch.inference_mode():
            return model(ids, vals, **kw)

    def serve(feat_ids: np.ndarray, feat_vals: np.ndarray):
        ids = torch.from_numpy(np.ascontiguousarray(feat_ids, np.int32)
                               ).to(dev)
        vals = torch.from_numpy(np.ascontiguousarray(feat_vals, np.float32)
                                ).to(dev)
        probs = host_sigmoid(raw_call(ids, vals).float().cpu().numpy())
        if len(names) > 1:
            return {name: probs[:, t] for t, name in enumerate(names)}
        return probs

    # Input width from the signature metadata: what a pre-warm caller (the
    # hot-swap watcher) needs to drive every bucket shape before the swap.
    in_cols = int(meta["signature"]["inputs"]["feat_ids"][1])
    serve.input_cols = in_cols
    serve.raw_call = raw_call
    if buckets is not None:
        wrapped = BucketedPredict(serve, buckets)
        wrapped.input_cols = in_cols
        wrapped.raw_call = raw_call
        return wrapped
    return serve


# --------------------------------------------------------------------------
# LATEST pointer + hot-swap consumer
# --------------------------------------------------------------------------

def write_latest(publish_dir: str, version: str) -> None:
    """Point ``<publish_dir>/LATEST`` at artifact dir ``version`` (basename).
    Atomic: a crashed update leaves the previous pointer intact."""
    fileio.write_atomic(fileio.join(publish_dir, LATEST_FILE), str(version))


def read_latest(publish_dir: str) -> Optional[str]:
    """Full path of the newest published artifact, or None when no pointer
    exists yet (or it dangles — points at a dir that is gone)."""
    pointer = fileio.join(publish_dir, LATEST_FILE)
    if not fileio.exists(pointer):
        return None
    version = fileio.read_bytes(pointer).decode("utf-8").strip()
    if not version:
        return None
    path = fileio.join(publish_dir, version)
    return path if fileio.exists(path) else None


# Append-only audit sidecar next to LATEST: one JSON line per pointer move,
# so every deployment decision replays from the publish dir alone.
POINTER_HISTORY_FILE = "pointer_history.jsonl"


def append_pointer_event(publish_dir: str, version: str, actor: str,
                         reason: str = "", *,
                         wall_time: Optional[float] = None) -> Dict[str, Any]:
    """Append one pointer-history event; returns the entry written (or the
    tail entry when this is a replay).

    The write protocol is *append history, then move the pointer*: a crash
    between the two re-runs both on the healing retry, so an append whose
    ``(version, actor, reason)`` equals the tail entry's is skipped rather
    than duplicated."""
    entry = {"version": str(version), "actor": str(actor),
             "reason": str(reason),
             "wall_time": float(wall_time if wall_time is not None
                                else time.time())}
    history = pointer_history(publish_dir)
    if history:
        tail = history[-1]
        if all(tail.get(k) == entry[k] for k in ("version", "actor",
                                                  "reason")):
            return tail
    fileio.append(fileio.join(publish_dir, POINTER_HISTORY_FILE),
                  json.dumps(entry, sort_keys=True,
                             separators=(",", ":")) + "\n")
    return entry


def pointer_history(publish_dir: str) -> list:
    """All pointer-history events, oldest first. A torn final line (a crash
    mid-append) is dropped: the retried append rewrites it whole."""
    path = fileio.join(publish_dir, POINTER_HISTORY_FILE)
    if not fileio.exists(path):
        return []
    out = []
    for line in fileio.read_bytes(path).decode("utf-8").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            break  # torn tail: everything after it is suspect
    return out


class LatestWatcher:
    """Hot-swap serving consumer: follow ``LATEST`` without dropping requests.

    Callable with the same ``(feat_ids, feat_vals) -> probs`` signature as
    :func:`load_serving`'s result. A poll (background thread, or
    :meth:`check_once` for callers that drive it themselves) notices a new
    ``LATEST`` pointer, loads the NEW artifact completely off to the side,
    then swaps it in with one attribute assignment — requests in flight keep
    executing the old function; requests after the swap get the new one; no
    request ever observes a half-loaded model. A load failure (incomplete or
    vanished artifact) keeps the current model and retries next poll.
    """

    def __init__(self, publish_dir: str, *, poll_secs: float = 2.0,
                 on_swap: Optional[Callable[[str], None]] = None,
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 loader: Callable[[str], Callable] = load_serving,
                 start: bool = True,
                 prewarm: bool = True,
                 sleep: Optional[Callable[[float], None]] = None):
        self._publish_dir = publish_dir
        self._poll_secs = float(poll_secs)
        self._on_swap = on_swap
        self._on_error = on_error
        self._loader = loader
        self._prewarm = bool(prewarm)
        # Guards the (fn, current_path, swap_count) triple so current()
        # returns a consistent snapshot for the engine's version stamp.
        self._swap_lock = threading.Lock()
        self._stop = threading.Event()
        self._sleep = sleep if sleep is not None else self._stop.wait
        self._fn: Optional[Callable] = None
        self.current_path: Optional[str] = None
        self.swap_count = 0
        # Buckets driven off-thread before each swap.
        self.prewarmed_buckets = 0
        # Failed swap attempts (torn/marker-less/vanished artifact seen at
        # LATEST): the current model stayed live each time.
        self.swap_failures = 0
        # Unexpected poll-loop exceptions: the poll thread never dies on
        # them, but counts them (surfaced through ``ServingStats``).
        self.watcher_errors = 0
        self._thread: Optional[threading.Thread] = None
        self.check_once()
        if start:
            self._thread = threading.Thread(
                target=self._run, name="latest-watcher", daemon=True)
            self._thread.start()

    def check_once(self) -> bool:
        """Poll LATEST; swap if it moved. Returns True iff a swap happened."""
        path = read_latest(self._publish_dir)
        if path is None or path == self.current_path:
            return False
        try:
            fn = self._loader(path)
            if self._prewarm:
                self._warm_buckets(fn)
        except (ArtifactIncomplete, OSError, ValueError) as e:
            self.swap_failures += 1
            log.warning("hot-swap to %s deferred (%s); keeping current model",
                        path, e)
            return False
        with self._swap_lock:
            self._fn = fn  # the swap: one reference assignment
            self.current_path = path
            self.swap_count += 1
        if self._on_swap is not None:
            self._on_swap(path)
        return True

    def current(self):
        """Consistent ``(predict_fn, version)`` snapshot, where version is
        the ``swap_count`` that installed the function. Before the first
        artifact loads, the fn slot is the watcher itself (calling it
        raises the typed "no artifact published" error) at version 0."""
        with self._swap_lock:
            fn = self._fn if self._fn is not None else self
            return fn, self.swap_count

    def _warm_buckets(self, fn: Callable) -> None:
        """Drive every serving bucket through the NEW function before it is
        swapped in, still off to the side: the first call of each shape
        (kernel build and load, allocator growth) happens here, on the
        watcher thread, instead of on live traffic. Needs a bucketed loader
        result that advertises its input width (``load_serving(buckets=...)``
        does); anything else warms nothing."""
        buckets = getattr(fn, "buckets", None)
        cols = getattr(fn, "input_cols", None)
        if not buckets or not cols:
            return
        for b in buckets:
            fn(np.zeros((int(b), int(cols)), np.int32),
               np.zeros((int(b), int(cols)), np.float32))
            self.prewarmed_buckets += 1

    def _run(self) -> None:
        while not self._stop.is_set():
            self._sleep(self._poll_secs)
            if self._stop.is_set():
                return
            try:
                self.check_once()
            except Exception as e:  # never kill the serving thread
                self.watcher_errors += 1
                log.warning("LATEST poll failed (%s); retrying", e)
                if self._on_error is not None:
                    try:
                        self._on_error(e)
                    except Exception:
                        pass

    def __call__(self, feat_ids: np.ndarray,
                 feat_vals: np.ndarray) -> np.ndarray:
        fn = self._fn
        if fn is None:
            raise RuntimeError(
                f"no artifact published under {self._publish_dir} yet")
        return fn(feat_ids, feat_vals)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def watch_latest(publish_dir: str, **kwargs) -> LatestWatcher:
    """``load_serving`` that follows the LATEST pointer: returns a callable
    that hot-swaps to each newly published artifact without dropping a
    request. See :class:`LatestWatcher` (kwargs forwarded)."""
    return LatestWatcher(publish_dir, **kwargs)
