"""Decoded-epoch cache: frame+decode the dataset once, serve every later
epoch from contiguous ``(label, feat_ids, feat_vals)`` column slabs (the
port's copy of ``deepfm_tpu.data.cache``).

The staged pipeline pays frame+decode again every epoch for bytes that
never changed. This module keeps the decoded columns after the first pass
and lets later epochs skip straight to the shuffle pool:

* ``disk`` mode writes one ``.npy`` slab per column under
  ``<cache_dir>/<fingerprint>/`` and re-opens them memory-mapped, so a
  warm epoch costs page-cache reads instead of proto decode.
* ``ram`` mode keeps the concatenated columns in a small process-global
  registry (the training driver recreates its pipeline every epoch, so
  the cache must outlive any one pipeline instance).

Entries are keyed by a fingerprint over the file list (absolute paths,
sizes, mtimes), the decoder/codec version, the CRC setting, the
bad-record policy, and the field width — anything that changes the
decoded rows forces a rebuild rather than serving stale columns. A slab
that fails validation (bad magic, shape mismatch, unreadable) is counted
into :class:`~deepfm_tpu_torch.data.health.DataHealth`, purged, and rebuilt
from the source stream — corruption degrades to one extra decode pass,
never to wrong data or a crash.

Columns are stored in CANONICAL file order (the pipeline's ``files``
list) with per-file record counts, so any epoch's arrival order — the
per-epoch seeded file shuffle — is a cheap reordering of per-file
segments, and the device-resident fit path can upload the whole epoch
as-is and gather batches by index on device.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .health import DataHealth

# Bump when the slab layout or fingerprint recipe changes: old entries
# then miss cleanly and rebuild instead of misparsing.
CACHE_FORMAT_VERSION = 1

MODES = ("off", "ram", "disk")

_META_NAME = "meta.json"
_SLABS = ("label", "feat_ids", "feat_vals")


class CacheColumns(NamedTuple):
    """One decoded epoch as contiguous columns (canonical file order)."""

    labels: np.ndarray   # [n] float32
    ids: np.ndarray      # [n, field_size] int32
    vals: np.ndarray     # [n, field_size] float32
    counts: np.ndarray   # [num_files] int64, records per canonical file

    @property
    def num_records(self) -> int:
        return int(self.labels.shape[0])

    def nbytes(self) -> int:
        return int(self.labels.nbytes + self.ids.nbytes + self.vals.nbytes)


def decoder_version(use_native: bool = True) -> str:
    """Identity of the decode implementation baked into cached rows: the
    native decoder's source digest, or the Python codec's version."""
    if use_native:
        from ..native import loader  # noqa: PLC0415
        return f"native-{loader.source_digest()}"
    return "python-1"


def compute_fingerprint(files: List[str], *, field_size: int,
                        verify_crc: bool, on_bad_record: str,
                        max_bad_records: int, use_native: bool = True) -> str:
    """Hash of everything that determines the decoded rows."""
    ident: List[object] = [CACHE_FORMAT_VERSION, decoder_version(use_native),
                           int(field_size), bool(verify_crc),
                           str(on_bad_record), int(max_bad_records)]
    for path in files:
        ap = os.path.abspath(path)
        try:
            st = os.stat(ap)
            ident.append([ap, st.st_size, st.st_mtime_ns])
        except OSError:
            # Unstattable (vanished): identity falls back to the path.
            ident.append([ap, -1, -1])
    digest = hashlib.sha256(
        json.dumps(ident, separators=(",", ":")).encode()).hexdigest()
    return digest[:32]


# ---------------------------------------------------------------------------
# RAM registry: process-global, bounded. Keyed by fingerprint so a changed
# dataset (or policy) naturally misses; a tiny LRU cap keeps a long-lived
# process that walks many datasets from accumulating epochs forever.
# ---------------------------------------------------------------------------
_RAM_LOCK = threading.Lock()
_RAM_REGISTRY: Dict[str, CacheColumns] = {}
_RAM_MAX_ENTRIES = 2


def _ram_get(fp: str) -> Optional[CacheColumns]:
    with _RAM_LOCK:
        cols = _RAM_REGISTRY.pop(fp, None)
        if cols is not None:
            _RAM_REGISTRY[fp] = cols  # re-insert: LRU order
        return cols


def _ram_put(fp: str, cols: CacheColumns) -> None:
    with _RAM_LOCK:
        _RAM_REGISTRY.pop(fp, None)
        _RAM_REGISTRY[fp] = cols
        while len(_RAM_REGISTRY) > _RAM_MAX_ENTRIES:
            _RAM_REGISTRY.pop(next(iter(_RAM_REGISTRY)))


def clear_ram_cache() -> None:
    """Testing hook: drop every RAM-cached epoch."""
    with _RAM_LOCK:
        _RAM_REGISTRY.clear()


class DecodedEpochCache:
    """Lookup/store façade over one dataset's cache entry.

    ``mode`` is one of :data:`MODES`. The cache never decodes anything
    itself — the pipeline passes a builder callable to
    :meth:`get_or_build`, keeping frame/CRC/bad-record semantics in one
    place (the pipeline) and persistence in another (here).
    """

    def __init__(self, mode: str, cache_dir: str, files: List[str], *,
                 field_size: int, verify_crc: bool, on_bad_record: str,
                 max_bad_records: int, use_native: bool = True,
                 health: Optional[DataHealth] = None) -> None:
        if mode not in MODES:
            raise ValueError(f"decoded_cache must be one of {MODES}, "
                             f"got {mode!r}")
        if mode == "disk" and not cache_dir:
            raise ValueError("decoded_cache='disk' requires a cache dir")
        self.mode = mode
        self.cache_dir = cache_dir
        self.files = list(files)
        self.field_size = int(field_size)
        self.health = health
        self._decoder = decoder_version(use_native)
        self._fp = compute_fingerprint(
            self.files, field_size=field_size, verify_crc=verify_crc,
            on_bad_record=on_bad_record, max_bad_records=max_bad_records,
            use_native=use_native)

    # -- identity -----------------------------------------------------
    @property
    def fingerprint(self) -> str:
        return self._fp

    @property
    def entry_dir(self) -> str:
        return os.path.join(self.cache_dir, self._fp)

    # -- lookup -------------------------------------------------------
    def load(self) -> Optional[CacheColumns]:
        """The cached columns, or None on miss. A present-but-invalid
        entry counts into DataHealth, is purged, and reads as a miss."""
        if self.mode == "off":
            return None
        if self.mode == "ram":
            return _ram_get(self._fp)
        entry = self.entry_dir
        if not os.path.isdir(entry):
            return None
        try:
            return self._load_disk(entry)
        except Exception as exc:
            self._note_corrupt(entry, exc)
            shutil.rmtree(entry, ignore_errors=True)
            return None

    def _load_disk(self, entry: str) -> CacheColumns:
        with open(os.path.join(entry, _META_NAME)) as f:
            meta = json.load(f)
        if (meta.get("format") != CACHE_FORMAT_VERSION
                or meta.get("fingerprint") != self._fp):
            raise ValueError(f"stale cache meta: {meta}")
        n = int(meta["num_records"])
        counts = np.asarray(meta["counts"], np.int64)
        if int(counts.sum()) != n or len(counts) != len(self.files):
            raise ValueError("cache meta counts inconsistent")
        arrs = {}
        for name, dtype, shape in (
                ("label", np.float32, (n,)),
                ("feat_ids", np.int32, (n, self.field_size)),
                ("feat_vals", np.float32, (n, self.field_size))):
            a = np.load(os.path.join(entry, name + ".npy"), mmap_mode="r")
            if a.dtype != dtype or a.shape != shape:
                raise ValueError(
                    f"cache slab {name}: dtype/shape {a.dtype}{a.shape} != "
                    f"{np.dtype(dtype)}{shape}")
            arrs[name] = a
        return CacheColumns(arrs["label"], arrs["feat_ids"],
                            arrs["feat_vals"], counts)

    def _note_corrupt(self, entry: str, exc: Exception) -> None:
        if self.health is not None:
            self.health.record_bad_record(entry)
        warnings.warn(
            f"decoded-epoch cache entry {entry} invalid ({exc}); "
            f"rebuilding from source stream", RuntimeWarning, stacklevel=3)

    # -- store --------------------------------------------------------
    def store(self, cols: CacheColumns) -> CacheColumns:
        """Persist freshly decoded columns; returns the (possibly
        memory-mapped) columns future readers will see."""
        if self.mode == "ram":
            _ram_put(self._fp, cols)
            return cols
        if self.mode != "disk":
            return cols
        os.makedirs(self.cache_dir, exist_ok=True)
        # Stage into a temp dir and rename: readers only ever see a
        # complete entry.
        tmp = tempfile.mkdtemp(prefix=f".{self._fp}.", dir=self.cache_dir)
        try:
            np.save(os.path.join(tmp, "label.npy"),
                    np.ascontiguousarray(cols.labels, np.float32))
            np.save(os.path.join(tmp, "feat_ids.npy"),
                    np.ascontiguousarray(cols.ids, np.int32))
            np.save(os.path.join(tmp, "feat_vals.npy"),
                    np.ascontiguousarray(cols.vals, np.float32))
            meta = {"format": CACHE_FORMAT_VERSION, "fingerprint": self._fp,
                    "num_records": cols.num_records,
                    "field_size": self.field_size,
                    "counts": [int(c) for c in cols.counts],
                    "decoder": self._decoder}
            with open(os.path.join(tmp, _META_NAME), "w") as f:
                json.dump(meta, f)
            entry = self.entry_dir
            shutil.rmtree(entry, ignore_errors=True)
            os.replace(tmp, entry)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        loaded = self.load()
        return loaded if loaded is not None else cols

    def get_or_build(self, builder: Callable[[], CacheColumns]
                     ) -> CacheColumns:
        cols = self.load()
        if cols is not None:
            return cols
        return self.store(builder())


def epoch_chunks(cols: CacheColumns, file_order: List[int],
                 chunk_records: int = 1 << 16
                 ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Slice cached columns into per-file (label, ids, vals) chunk views
    following ``file_order`` — the arrival stream one epoch's shuffle pool
    consumes, without touching the source bytes. Views are zero-copy into
    the slab (or memmap); the pool scatter copies rows out at drain time."""
    starts = np.zeros(len(cols.counts) + 1, np.int64)
    np.cumsum(cols.counts, out=starts[1:])
    out: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for fi in file_order:
        lo, hi = int(starts[fi]), int(starts[fi + 1])
        for s in range(lo, hi, chunk_records):
            e = min(s + chunk_records, hi)
            if e > s:
                out.append((cols.labels[s:e], cols.ids[s:e],
                            cols.vals[s:e]))
    return out
