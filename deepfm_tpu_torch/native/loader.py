"""ctypes bindings of the native TFRecord decoder (``tfrecord_native.cc``):
record framing, CRC32C and the CTR ``tf.train.Example`` decode in C++.

The port's copy of ``deepfm_tpu.native.loader`` less the two-label and
history decodes. The library is built with the host compiler,
``g++ -O3 -shared -fPIC -std=c++17``, at first use into
``deepfm_tpu_torch/_build/``, under a file name that carries a hash of the
source and the flags, so an edited source never loads a stale build. Builds
are serialised by a thread lock and a lock file (concurrent test workers
wait for one compiler run), and the library is installed with an atomic
``os.replace``.

There is no fallback: a build that fails raises
:class:`~deepfm_tpu_torch._native.KernelBuildError` with the compiler's
output. ``use_native_decoder=False`` is the explicit per-record Python path.

Every entry point releases the GIL inside its C call (``ctypes.CDLL``), so
reader threads decode in parallel. Every buffer and index array handed to
C stays referenced by the calling frame until the call returns.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import _native

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "tfrecord_native.cc")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_LONGP = ctypes.POINTER(ctypes.c_long)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_ubyte)


def gxx_path() -> str:
    found = shutil.which("g++")
    if not found:
        raise _native.KernelBuildError(
            "g++ not found on PATH; the port's native TFRecord decoder is "
            "built from source at first use (use_native_decoder=False "
            "decodes per record in Python instead)")
    return found


def source_digest() -> str:
    """Hash of the decoder's source and build flags (the library's key)."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(_native.BUILD_DIR,
                        f"libtfrecord_{source_digest()}.so")


def build() -> float:
    """Build the decoder unless it is built; returns the wall seconds spent.
    Raises ``KernelBuildError`` with the compiler's output on failure."""
    t0 = time.perf_counter()
    out = library_path()
    if os.path.exists(out):
        return 0.0
    with _lock:
        os.makedirs(_native.BUILD_DIR, exist_ok=True)
        with open(os.path.join(_native.BUILD_DIR, ".tfrecord.lock"),
                  "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if os.path.exists(out):
                return time.perf_counter() - t0
            tmp = f"{out}.{os.getpid()}.tmp"
            res = subprocess.run(
                [gxx_path(), *GXX_FLAGS, SOURCE, "-o", tmp],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise _native.KernelBuildError(
                    f"g++ failed on tfrecord_native.cc (exit "
                    f"{res.returncode}):\n{res.stdout}")
            os.replace(tmp, out)
    return time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> None:
    # Buffer params are raw pointers (not c_char_p), so zero-copy views of
    # bytes and memoryviews both pass through np.frombuffer.
    lib.dfm_split_frames.restype = ctypes.c_long
    lib.dfm_split_frames.argtypes = [
        _U8P, ctypes.c_long, ctypes.c_long, ctypes.c_long, _LONGP, _LONGP]
    lib.dfm_split_frames_ex.restype = ctypes.c_long
    lib.dfm_split_frames_ex.argtypes = [
        _U8P, ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        _LONGP, _LONGP, _LONGP]
    lib.dfm_decode_ctr_ex.restype = ctypes.c_long
    lib.dfm_decode_ctr_ex.argtypes = [
        _U8P, _LONGP, _LONGP, ctypes.c_long, ctypes.c_long,
        _F32P, _I32P, _F32P, _LONGP]
    lib.dfm_decode_ctr_scatter.restype = ctypes.c_long
    lib.dfm_decode_ctr_scatter.argtypes = [
        _U8P, _LONGP, _LONGP, ctypes.c_long, ctypes.c_long, _LONGP,
        _F32P, _I32P, _F32P, _LONGP]
    lib.dfm_decode_ctr_assemble.restype = ctypes.c_long
    lib.dfm_decode_ctr_assemble.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), _LONGP, ctypes.c_long,
        ctypes.c_long, _LONGP, _F32P, _I32P, _F32P, _LONGP, _LONGP]
    lib.dfm_crc32c.restype = ctypes.c_uint32
    lib.dfm_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_long]


def load() -> ctypes.CDLL:
    """The loaded decoder library, built first if needed."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(library_path())
            _bind(lib)
            _lib = lib
        return _lib


def _ptr(buf) -> "ctypes.POINTER(ctypes.c_ubyte)":
    """Zero-copy pointer to a bytes-like object (bytes, memoryview)."""
    return np.frombuffer(buf, dtype=np.uint8).ctypes.data_as(_U8P)


def _p(arr: np.ndarray, typ):
    return arr.ctypes.data_as(typ)


def crc32c(data: bytes) -> int:
    return int(load().dfm_crc32c(data, len(data)))


def split_frames_partial(buf, *, verify_crc: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Like :func:`split_frames`, but an incomplete trailing record is left
    for the next chunk: returns ``(offsets, lengths, consumed)``, where
    ``consumed`` counts the bytes of fully framed records and the caller
    carries ``buf[consumed:]`` into the next read."""
    lib = load()
    cap = max(len(buf) // 16, 1)  # every record takes >= 16 bytes on disk
    offsets = np.empty(cap, dtype=np.int64)
    lengths = np.empty(cap, dtype=np.int64)
    consumed = ctypes.c_long(0)
    n = lib.dfm_split_frames_ex(
        _ptr(buf), len(buf), int(verify_crc), 1, cap,
        _p(offsets, _LONGP), _p(lengths, _LONGP), ctypes.byref(consumed))
    if n == -2:
        raise IOError("corrupt TFRecord: CRC mismatch")
    if n < 0:
        raise IOError(f"TFRecord split error {n}")
    return offsets[:n], lengths[:n], int(consumed.value)


def split_frames(buf, *, verify_crc: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Payload offsets and lengths of every record of a TFRecord buffer."""
    lib = load()
    cap = max(len(buf) // 16, 1)
    offsets = np.empty(cap, dtype=np.int64)
    lengths = np.empty(cap, dtype=np.int64)
    n = lib.dfm_split_frames(_ptr(buf), len(buf), int(verify_crc), cap,
                             _p(offsets, _LONGP), _p(lengths, _LONGP))
    if n == -1:
        raise IOError("truncated TFRecord")
    if n == -2:
        raise IOError("corrupt TFRecord: CRC mismatch")
    if n < 0:
        raise IOError(f"TFRecord split error {n}")
    return offsets[:n], lengths[:n]


def decode_spans(buf, offsets: np.ndarray, lengths: np.ndarray,
                 field_size: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode the records at ``buf[offsets[i]:offsets[i] + lengths[i]]`` ->
    (labels [n] float32, ids [n, F] int32, vals [n, F] float32)."""
    lib = load()
    n = len(offsets)
    labels = np.empty(n, dtype=np.float32)
    ids = np.empty((n, field_size), dtype=np.int32)
    vals = np.empty((n, field_size), dtype=np.float32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    detail = ctypes.c_long(0)
    rc = lib.dfm_decode_ctr_ex(
        _ptr(buf), _p(offsets, _LONGP), _p(lengths, _LONGP), n, field_size,
        _p(labels, _F32P), _p(ids, _I32P), _p(vals, _F32P),
        ctypes.byref(detail))
    if rc != 0:
        raise ValueError(f"native decode failed at record {-rc - 100}: "
                         f"{_decode_reason(detail.value, field_size)}")
    return labels, ids, vals


def _decode_reason(code: int, field_size: int) -> str:
    """Readable reason for a ``parse_ctr_example`` error code."""
    reasons = {
        -20: "'label' is not a single float",
        -21: f"'ids' length != field_size={field_size}",
        -22: f"'values' length != field_size={field_size}",
        -23: ("required keys missing — need 'label' plus 'ids'/'values' "
              "(reference schema) or 'feat_ids'/'feat_vals' (legacy)"),
    }
    return reasons.get(code, f"malformed Example wire data (code {code})")


def decode_spans_scatter(buf, offsets: np.ndarray, lengths: np.ndarray,
                         field_size: int, dest: np.ndarray,
                         labels: np.ndarray, ids: np.ndarray,
                         vals: np.ndarray) -> None:
    """Decode record i of ``buf`` straight into row ``dest[i]`` of the
    caller's pool arrays (``labels`` [P], ``ids`` [P, F] int32, ``vals``
    [P, F] float32, C-contiguous). The C side writes unchecked, so ``dest``
    is validated here; the caller keeps concurrent calls' rows disjoint."""
    lib = load()
    n = len(offsets)
    if not (labels.flags.c_contiguous and ids.flags.c_contiguous
            and vals.flags.c_contiguous):
        raise ValueError("decode_spans_scatter: pool arrays must be "
                         "C-contiguous")
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    dest = np.ascontiguousarray(dest, dtype=np.int64)
    if len(dest) != n:
        raise ValueError(f"decode_spans_scatter: len(dest)={len(dest)} != "
                         f"len(offsets)={n}")
    rows = min(len(labels), len(ids), len(vals))
    if n and (int(dest.min()) < 0 or int(dest.max()) >= rows):
        raise ValueError(
            f"decode_spans_scatter: dest range [{int(dest.min())}, "
            f"{int(dest.max())}] outside pool of {rows} rows")
    if n == 0:
        return
    detail = ctypes.c_long(0)
    rc = lib.dfm_decode_ctr_scatter(
        _ptr(buf), _p(offsets, _LONGP), _p(lengths, _LONGP), n, field_size,
        _p(dest, _LONGP), _p(labels, _F32P), _p(ids, _I32P),
        _p(vals, _F32P), ctypes.byref(detail))
    if rc != 0:
        raise ValueError(
            f"native scatter-decode failed at span-local record "
            f"{-rc - 100}: {_decode_reason(detail.value, field_size)}")


def _validate_assemble_jobs(jobs, labels, ids, vals) -> None:
    """Bounds check shared by :func:`assemble_spans` and its Python
    mirror: every destination row is checked before any pointer reaches
    the unchecked C scatter."""
    if not (labels.flags.c_contiguous and ids.flags.c_contiguous
            and vals.flags.c_contiguous):
        raise ValueError("assemble_spans: pool arrays must be C-contiguous")
    rows = min(labels.shape[0], ids.shape[0], vals.shape[0])
    for _, offsets, _, dest in jobs:
        if len(dest) != len(offsets):
            raise ValueError(f"assemble_spans: len(dest)={len(dest)} != "
                             f"len(offsets)={len(offsets)}")
        if len(dest) and (int(dest.min()) < 0 or int(dest.max()) >= rows):
            raise ValueError(
                f"assemble_spans: dest range [{int(dest.min())}, "
                f"{int(dest.max())}] outside pool of {rows} rows")


def assemble_spans(jobs, field_size: int, labels: np.ndarray,
                   ids: np.ndarray, vals: np.ndarray) -> None:
    """Decode every chunk span of a drain straight into its permuted rows
    of the output buffers, in ONE GIL-released C call.

    ``jobs`` is a sequence of ``(buf, offsets, lengths, dest)``; ``labels``
    is [P] or [P, 1] float32, ``ids``/``vals`` [P, F]. Bounds and
    disjointness as for :func:`decode_spans_scatter`; the bytes written are
    the same as one ``decode_spans_scatter`` per job."""
    lib = load()
    if not jobs:
        return
    norm = [(buf, np.ascontiguousarray(offsets, dtype=np.int64),
             np.ascontiguousarray(lengths, dtype=np.int64),
             np.ascontiguousarray(dest, dtype=np.int64))
            for buf, offsets, lengths, dest in jobs]
    _validate_assemble_jobs(norm, labels, ids, vals)
    n_chunks = len(norm)
    # Pointer tables over the chunks. ``norm`` (arrays and buffers) and
    # ``views`` stay referenced until the call returns.
    views = [np.frombuffer(j[0], dtype=np.uint8) for j in norm]
    bufs_arr = (ctypes.c_void_p * n_chunks)(*(v.ctypes.data for v in views))
    offs_arr = (ctypes.c_void_p * n_chunks)(*(j[1].ctypes.data for j in norm))
    lens_arr = (ctypes.c_void_p * n_chunks)(*(j[2].ctypes.data for j in norm))
    counts = np.fromiter((len(j[1]) for j in norm), dtype=np.int64,
                         count=n_chunks)
    dest_all = (norm[0][3] if n_chunks == 1
                else np.concatenate([j[3] for j in norm]))
    err_chunk = ctypes.c_long(-1)
    detail = ctypes.c_long(0)
    rc = lib.dfm_decode_ctr_assemble(
        bufs_arr, offs_arr, lens_arr, _p(counts, _LONGP), n_chunks,
        field_size, _p(dest_all, _LONGP), _p(labels, _F32P),
        _p(ids, _I32P), _p(vals, _F32P), ctypes.byref(err_chunk),
        ctypes.byref(detail))
    if rc != 0:
        raise ValueError(
            f"native assemble failed at record {-rc - 100} of chunk "
            f"{err_chunk.value}: {_decode_reason(detail.value, field_size)}")


def assemble_spans_python(jobs, field_size: int, labels: np.ndarray,
                          ids: np.ndarray, vals: np.ndarray) -> None:
    """Python mirror of :func:`assemble_spans` with the same bytes: each
    record decodes with the Python codec into its destination row. The
    reference the C entry is tested against."""
    from ..data import example_codec  # noqa: PLC0415 (module cycle)
    norm = [(j[0], np.asarray(j[1]), np.asarray(j[2]), np.asarray(j[3]))
            for j in jobs]
    _validate_assemble_jobs(norm, labels, ids, vals)
    lab_flat = labels.reshape(-1)
    for buf, offsets, lengths, dest in norm:
        for off, ln, d in zip(offsets.tolist(), lengths.tolist(),
                              dest.tolist()):
            lab, rid, rval = example_codec.decode_ctr_example(
                bytes(buf[off:off + ln]), field_size)
            lab_flat[d] = lab
            ids[d] = rid.astype(np.int32)
            vals[d] = rval


def decode_batch(records: Sequence[bytes], field_size: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a list of serialized Examples in one C call."""
    buf = b"".join(records)
    lengths = np.fromiter((len(r) for r in records), dtype=np.int64,
                          count=len(records))
    offsets = np.zeros(len(records), dtype=np.int64)
    if len(records) > 1:
        np.cumsum(lengths[:-1], out=offsets[1:])
    return decode_spans(buf, offsets, lengths, field_size)


def decode_file_bytes(buf: bytes, field_size: int, *, verify_crc: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frame and decode a whole TFRecord file buffer."""
    offsets, lengths = split_frames(buf, verify_crc=verify_crc)
    return decode_spans(buf, offsets, lengths, field_size)
