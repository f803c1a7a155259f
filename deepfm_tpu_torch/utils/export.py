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
forward under ``torch.inference_mode()``, sigmoid, numpy out.

Paths are local. Remote storage schemes (the JAX package's ``fileio``
layer), StableHLO and the TF SavedModel sidecar are not part of the port.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
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


def write_atomic(path: str, text: str) -> None:
    """Write ``text`` to ``path`` so readers see the old or the new file,
    never a torn one."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def export_serving(model: torch.nn.Module, cfg: Config, out_dir: str, *,
                   step: int = 0) -> str:
    """Write the servable artifact of ``model``; returns the artifact path."""
    os.makedirs(out_dir, exist_ok=True)

    # 1. Weights: one flat {name: tensor} dict, on the CPU, so any device
    # can load it.
    flat = {k: v.detach().cpu().contiguous()
            for k, v in model.state_dict().items()}
    torch.save(flat, os.path.join(out_dir, _PARAMS_FILE))

    # 2. Signature/config metadata (the JAX package's schema). History-aware
    # models, whose inputs are wider, are not ported.
    in_cols = cfg.field_size
    meta = {
        "signature": {
            "inputs": {
                "feat_ids": ["batch", in_cols, "int32"],
                "feat_vals": ["batch", in_cols, "float32"],
            },
            "outputs": {"prob": ["batch", "float32"]},
        },
        "model": cfg.model,
        "history_len": 0,
        "config": cfg.to_dict(),
        "step": int(step),
    }
    with open(os.path.join(out_dir, _CONFIG_FILE), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())

    # 3. Completion marker — strictly last, atomically.
    write_atomic(os.path.join(out_dir, COMPLETE_MARKER),
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
    if not os.path.exists(os.path.join(artifact_dir, COMPLETE_MARKER)):
        raise ArtifactIncomplete(
            f"{artifact_dir} has no {COMPLETE_MARKER} marker — the artifact "
            "is incomplete (crashed or in-flight export); refusing to load")
    dev = device_lib.resolve(device)
    with open(os.path.join(artifact_dir, _CONFIG_FILE), encoding="utf-8") as f:
        meta = json.load(f)
    cfg = Config.from_dict({**meta["config"], **overrides})
    weights = torch.load(os.path.join(artifact_dir, _PARAMS_FILE),
                         map_location=dev, weights_only=True)
    from ..models import get_model  # noqa: PLC0415 (models import this package)
    model = get_model(cfg, device="meta")
    model.load_state_dict(weights, assign=True)
    return model.eval(), cfg, meta


def load_serving(artifact_dir: str, *,
                 buckets: Optional[Sequence[int]] = None, device="cuda"
                 ) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Reload a servable artifact as ``f(feat_ids, feat_vals) -> probs``.

    With ``buckets`` the result is a :class:`BucketedPredict` — every call
    pads to the next bucket size (the serving engine's shape policy).

    Raises :class:`ArtifactIncomplete` when the dir lacks its completion
    marker — the dir is mid-write, or an export crashed into it. Callers
    that poll (``watch_latest``) treat this as "try again later"; everything
    else should treat it as a corrupt deployment.
    """
    model, _, meta = load_model(artifact_dir, device=device)
    dev = model.fm_v.device

    def serve(feat_ids: np.ndarray, feat_vals: np.ndarray) -> np.ndarray:
        ids = torch.from_numpy(np.ascontiguousarray(feat_ids, np.int32))
        vals = torch.from_numpy(np.ascontiguousarray(feat_vals, np.float32))
        with torch.inference_mode():
            probs = torch.sigmoid(model(ids.to(dev), vals.to(dev)))
            return probs.cpu().numpy()

    # Input width from the signature metadata: what a pre-warm caller (the
    # hot-swap watcher) needs to drive every bucket shape before the swap.
    in_cols = int(meta["signature"]["inputs"]["feat_ids"][1])
    serve.input_cols = in_cols
    if buckets is not None:
        wrapped = BucketedPredict(serve, buckets)
        wrapped.input_cols = in_cols
        return wrapped
    return serve


# --------------------------------------------------------------------------
# LATEST pointer + hot-swap consumer
# --------------------------------------------------------------------------

def write_latest(publish_dir: str, version: str) -> None:
    """Point ``<publish_dir>/LATEST`` at artifact dir ``version`` (basename).
    Atomic: a crashed update leaves the previous pointer intact."""
    write_atomic(os.path.join(publish_dir, LATEST_FILE), str(version))


def read_latest(publish_dir: str) -> Optional[str]:
    """Full path of the newest published artifact, or None when no pointer
    exists yet (or it dangles — points at a dir that is gone)."""
    pointer = os.path.join(publish_dir, LATEST_FILE)
    if not os.path.exists(pointer):
        return None
    with open(pointer, "rb") as f:
        version = f.read().decode("utf-8").strip()
    if not version:
        return None
    path = os.path.join(publish_dir, version)
    return path if os.path.exists(path) else None


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
