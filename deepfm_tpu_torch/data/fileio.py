"""Filesystem seam of the input path, local paths only (the port's copy of
the local half of ``deepfm_tpu.data.fileio``).

Every metadata op and every open runs under the module
:class:`~deepfm_tpu_torch.utils.retry.RetryPolicy`, and
:class:`ResilientStream` heals transient *mid-read* failures by reopening
and seeking to the last good byte offset. A process-wide fault injector
(:func:`set_fault_injector`, ``utils.faults.FlakyFS``) scripts failures
INSIDE the retry loop, so the healing path itself is what gets exercised.

Remote object stores (``gs://`` and the like) are not ported: such a path
raises ``NotImplementedError``.
"""

from __future__ import annotations

import glob as _glob
import io
import os
import shutil
import threading
from typing import BinaryIO, Callable, List, Optional

from ..utils import retry as _retry

# Module retry policy for filesystem ops; tasks apply the --io_retry_* knobs.
_retry_policy = _retry.RetryPolicy()

# Process-wide fault injector (see utils/faults.py). None in production.
_injector = None


def set_retry_policy(policy: _retry.RetryPolicy) -> _retry.RetryPolicy:
    """Install the retry policy for all fileio ops; returns the previous."""
    global _retry_policy
    prev, _retry_policy = _retry_policy, policy
    return prev


def get_retry_policy() -> _retry.RetryPolicy:
    return _retry_policy


def set_fault_injector(inj) -> None:
    """Install (or with None, remove) the process-wide fault injector: an
    object with ``on_op(op_name, path)``, called inside the retry loop
    before each metadata op or open (raise to inject), and
    ``wrap_stream(path, stream)``, called on each freshly opened read
    stream (return a wrapper to inject read faults)."""
    global _injector
    _injector = inj


def is_remote(path: str) -> bool:
    return "://" in path


def _local(path: str) -> str:
    if is_remote(path):
        raise NotImplementedError(
            f"remote path {path!r}: object stores are not yet ported to "
            "deepfm_tpu_torch (local files only)")
    return path


def open_stream(path: str, mode: str = "rb") -> BinaryIO:
    """Open a local path, retrying transient open failures."""
    _local(path)

    def _open() -> BinaryIO:
        if _injector is not None:
            _injector.on_op("open", path)
        f: BinaryIO = open(path, mode)
        if _injector is not None and "r" in mode and "+" not in mode:
            f = _injector.wrap_stream(path, f)
        return f
    return _retry_policy.call(_open, op_name=f"open({path})")


def size(path: str) -> int:
    """Byte length of a local file."""
    _local(path)

    def _size_op() -> int:
        if _injector is not None:
            _injector.on_op("size", path)
        return os.path.getsize(path)
    return _retry_policy.call(_size_op, op_name=f"size({path})")


def _metadata_op(name: str, path: str, fn: Callable[[], object]):
    """``fn`` under the retry policy, with the fault injector's hook."""
    _local(path)

    def _op():
        if _injector is not None:
            _injector.on_op(name, path)
        return fn()
    return _retry_policy.call(_op, op_name=f"{name}({path})")


def glob(pattern: str) -> List[str]:
    """Sorted matches of a local glob pattern."""
    return _metadata_op("glob", pattern,
                        lambda: sorted(_glob.glob(pattern)))


def isdir(path: str) -> bool:
    return _metadata_op("isdir", path, lambda: os.path.isdir(path))


def exists(path: str) -> bool:
    return _metadata_op("exists", path, lambda: os.path.exists(path))


def makedirs(path: str) -> None:
    os.makedirs(_local(path), exist_ok=True)


def rmtree(path: str) -> None:
    shutil.rmtree(_local(path))


def replace(src: str, dst: str) -> None:
    """Atomically move ``src`` over ``dst`` (file or directory): readers see
    the old artifact or the complete new one, never a partial state."""
    os.replace(_local(src), _local(dst))


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-completed rename survives a crash."""
    try:
        fd = os.open(_local(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_atomic(path: str, data) -> None:
    """Write ``data`` (str or bytes) so readers see the old content or the
    new, never a torn file: a same-directory temp file, flushed and
    fsynced, renamed over ``path``, then the directory fsynced. Every
    pointer and sidecar of the online path (``LATEST``, the stream's
    high-water mark) is written so."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    d = os.path.dirname(_local(path)) or "."
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    fsync_dir(d)


class ResilientStream(io.RawIOBase):
    """Sequential read stream that survives transient mid-file failures.

    Tracks the absolute byte offset of delivered data; when a read raises a
    transient error the broken stream is dropped and, under the retry
    policy's backoff, a fresh one is opened and repositioned to the last
    good offset (``seek`` where the stream supports it, else
    read-and-discard). ``read(n)`` returns exactly ``n`` bytes except at
    EOF, so the strictly sequential framers get mid-file fault survival
    without changes of their own.
    """

    _DISCARD_CHUNK = 1 << 20

    def __init__(self, path: str = "", *,
                 opener: Optional[Callable[[], BinaryIO]] = None,
                 policy: Optional[_retry.RetryPolicy] = None,
                 on_retry: Optional[Callable[[BaseException, int],
                                             None]] = None):
        super().__init__()
        if opener is None:
            if not path:
                raise ValueError("ResilientStream needs a path or an opener")
            opener = lambda: open_stream(path, "rb")  # noqa: E731
        self._opener = opener
        self._path = path or "<stream>"
        self._policy = policy or _retry_policy
        self._on_retry = on_retry
        self._stream: Optional[BinaryIO] = None
        self._offset = 0  # absolute offset of the next byte owed the caller
        self.reopen_count = 0

    @property
    def path(self) -> str:
        return self._path

    def tell(self) -> int:
        return self._offset

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return False

    def _drop(self) -> None:
        s, self._stream = self._stream, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass  # a broken stream may refuse even close()

    def _reposition(self, stream: BinaryIO) -> None:
        try:
            can_seek = bool(stream.seekable())
        except (OSError, ValueError):
            can_seek = False
        if can_seek:
            stream.seek(self._offset)
            return
        remaining = self._offset
        while remaining > 0:
            chunk = stream.read(min(remaining, self._DISCARD_CHUNK))
            if not chunk:
                raise IOError(
                    f"reopen of {self._path} hit EOF at byte "
                    f"{self._offset - remaining} before reaching the last "
                    f"good offset {self._offset}")
            remaining -= len(chunk)

    def _read_some(self, want: int) -> bytes:
        def attempt() -> bytes:
            if self._stream is None:
                stream = self._opener()
                if self._offset:
                    self._reposition(stream)
                self._stream = stream
            return self._stream.read(want)

        def on_retry(exc: BaseException, n: int) -> None:
            self._drop()
            self.reopen_count += 1
            if self._on_retry is not None:
                self._on_retry(exc, n)

        try:
            return self._policy.call(
                attempt, op_name=f"read({self._path}@{self._offset})",
                on_retry=on_retry)
        except BaseException:
            self._drop()
            raise

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = []
            while True:
                c = self.read(self._DISCARD_CHUNK)
                if not c:
                    return b"".join(chunks)
                chunks.append(c)
        if n == 0:
            return b""
        # Join the underlying reads once; the common case (one read
        # satisfies the request, or hits EOF) returns that chunk as is.
        chunks = []
        got = 0
        while got < n:
            chunk = self._read_some(n - got)
            if not chunk:
                break  # EOF
            self._offset += len(chunk)
            got += len(chunk)
            chunks.append(chunk)
        if len(chunks) == 1:
            return chunks[0]
        return b"".join(chunks)

    def close(self) -> None:
        self._drop()
        super().close()


def open_resilient(path: str, *,
                   policy: Optional[_retry.RetryPolicy] = None,
                   on_retry: Optional[Callable[[BaseException, int],
                                               None]] = None,
                   ) -> ResilientStream:
    """Open ``path`` for reading behind transparent reopen-and-seek retry."""
    _local(path)
    return ResilientStream(path, policy=policy, on_retry=on_retry)
