"""Filesystem seam: local paths plus remote object stores (``gs://`` and
the like); the port's copy of ``deepfm_tpu.data.fileio``.

Every byte-level reader of the port opens files through :func:`open_stream`
and lists them through :func:`glob`; checkpoints, artifacts, sidecars and
predictions go through the same functions. A URL-style path
(:func:`is_remote`) goes to the module's remote backend, an object with
``tf.io.gfile``'s duck type: ``GFile(path, mode)``, ``glob``, ``isdir``,
``exists``, ``stat(path).length``, ``makedirs``, ``rmtree``, ``remove`` and
``rename(src, dst, overwrite=True)``. :func:`set_remote_fs` installs one
(a test's stand-in, or a caller's own store). Otherwise the first remote op
builds the default backend over ``fsspec``, imported then and only then, so
a local run never needs the package; without it a remote path raises
``RuntimeError`` naming the scheme and the package. Any other path is plain
POSIX I/O.

Every metadata op and every open runs under the module
:class:`~deepfm_tpu_torch.utils.retry.RetryPolicy`, and
:class:`ResilientStream` heals transient *mid-read* failures by reopening
and seeking to the last good byte offset. A process-wide fault injector
(:func:`set_fault_injector`, ``utils.faults.FlakyFS``) scripts failures
INSIDE the retry loop, so the healing path itself is what gets exercised.
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

# The remote backend (tf.io.gfile's duck type); None until installed or
# until the first remote op builds the fsspec one.
_remote_fs = None


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


def set_remote_fs(fs):
    """Install the backend of remote paths (``tf.io.gfile``'s duck type);
    ``None`` goes back to the lazily built fsspec one. Returns the
    previous backend."""
    global _remote_fs
    prev, _remote_fs = _remote_fs, fs
    return prev


def is_remote(path: str) -> bool:
    return "://" in path


class FsspecGfile:
    """``tf.io.gfile``'s duck type over ``fsspec``: each path picks its
    filesystem by scheme, and listings come back as URIs of the form the
    caller used (``memory://b/x``, ``gs://bucket/x``)."""

    def __init__(self, fsspec):
        self._fsspec = fsspec

    def _fs(self, path: str):
        return self._fsspec.core.url_to_fs(path)

    def GFile(self, path: str, mode: str = "r"):  # noqa: N802 (gfile's name)
        return self._fsspec.open(path, mode).open()

    def glob(self, pattern: str) -> List[str]:
        scheme, rest = pattern.split("://", 1)
        fs, stripped = self._fs(pattern)
        return [f"{scheme}://{p if rest.startswith('/') else p.lstrip('/')}"
                for p in fs.glob(stripped)]

    def isdir(self, path: str) -> bool:
        fs, p = self._fs(path)
        return bool(fs.isdir(p))

    def exists(self, path: str) -> bool:
        fs, p = self._fs(path)
        return bool(fs.exists(p))

    def stat(self, path: str):
        fs, p = self._fs(path)
        return _Stat(int(fs.size(p)))

    def makedirs(self, path: str) -> None:
        fs, p = self._fs(path)
        fs.makedirs(p, exist_ok=True)

    def rmtree(self, path: str) -> None:
        fs, p = self._fs(path)
        fs.rm(p, recursive=True)

    def remove(self, path: str) -> None:
        fs, p = self._fs(path)
        fs.rm_file(p)

    def rename(self, src: str, dst: str, overwrite: bool = False) -> None:
        fs, s = self._fs(src)
        _, d = self._fs(dst)
        if fs.exists(d):
            if not overwrite:
                raise FileExistsError(dst)
            fs.rm(d, recursive=True)
        fs.mv(s, d, recursive=True)


class _Stat:
    def __init__(self, length: int):
        self.length = length


def _gfile(path: str):
    """The remote backend, built over fsspec at the first remote op."""
    global _remote_fs
    if _remote_fs is None:
        try:
            import fsspec  # noqa: PLC0415 (lazy: remote paths only)
        except ImportError as e:
            scheme = path.split("://", 1)[0]
            raise RuntimeError(
                f"remote path {path!r}: the {scheme}:// scheme needs the "
                "fsspec package (not installed); copy the data to a local "
                "path, or install fsspec, or set_remote_fs() a backend"
            ) from e
        _remote_fs = FsspecGfile(fsspec)
    return _remote_fs


def open_stream(path: str, mode: str = "rb") -> BinaryIO:
    """Open a (possibly remote) path, retrying transient open failures."""
    def _open() -> BinaryIO:
        if _injector is not None:
            _injector.on_op("open", path)
        if is_remote(path):
            f: BinaryIO = _gfile(path).GFile(path, mode)
        else:
            f = open(path, mode)
        if _injector is not None and "r" in mode and "+" not in mode:
            f = _injector.wrap_stream(path, f)
        return f
    return _retry_policy.call(_open, op_name=f"open({path})")


def read_bytes(path: str) -> bytes:
    """A whole (possibly remote) file: checkpoints, artifacts and sidecars.
    A remote path reads through :func:`open_stream`; a local file is read
    directly, outside the fault injector, which scripts faults into the
    input path's streams only."""
    if is_remote(path):
        with open_stream(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _metadata_op(name: str, path: str, local: Callable[[], object],
                 remote: Callable[[object], object]):
    """One metadata op under the retry policy, with the fault injector's
    hook: ``remote(backend)`` for a remote path, else ``local()``."""
    def _op():
        if _injector is not None:
            _injector.on_op(name, path)
        if is_remote(path):
            return remote(_gfile(path))
        return local()
    return _retry_policy.call(_op, op_name=f"{name}({path})")


def size(path: str) -> int:
    """Byte length of a (possibly remote) file."""
    return _metadata_op("size", path, lambda: os.path.getsize(path),
                        lambda g: int(g.stat(path).length))


def glob(pattern: str) -> List[str]:
    """Sorted matches of a (possibly remote) glob pattern."""
    return sorted(_metadata_op("glob", pattern,
                               lambda: _glob.glob(pattern),
                               lambda g: g.glob(pattern)))


def isdir(path: str) -> bool:
    return _metadata_op("isdir", path, lambda: os.path.isdir(path),
                        lambda g: g.isdir(path))


def exists(path: str) -> bool:
    return _metadata_op("exists", path, lambda: os.path.exists(path),
                        lambda g: g.exists(path))


def makedirs(path: str) -> None:
    if is_remote(path):
        _gfile(path).makedirs(path)
        return
    os.makedirs(path, exist_ok=True)


def rmtree(path: str) -> None:
    if is_remote(path):
        _gfile(path).rmtree(path)
        return
    shutil.rmtree(path)


def remove(path: str) -> None:
    """Delete one (possibly remote) file."""
    if is_remote(path):
        _gfile(path).remove(path)
        return
    os.remove(path)


def replace(src: str, dst: str) -> None:
    """Move ``src`` over ``dst`` (file or directory).

    Local paths use ``os.replace``, atomic on POSIX: readers see the old
    artifact or the complete new one, never a partial state. Remote stores
    rename with overwrite, and an object-store rename is not guaranteed
    atomic: a reader may see a partly moved directory there."""
    if is_remote(src) or is_remote(dst):
        _gfile(src if is_remote(src) else dst).rename(src, dst,
                                                      overwrite=True)
        return
    os.replace(src, dst)


def fsync_dir(path: str) -> None:
    """fsync a local directory so a just-completed rename survives a crash.
    A no-op on a remote store (durability is the store's contract)."""
    if is_remote(path):
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_atomic(path: str, data) -> None:
    """Write ``data`` (str or bytes) so readers see the old content or the
    new, never a torn file. Locally: a same-directory temp file, flushed
    and fsynced, renamed over ``path``, then the directory fsynced. Every
    pointer and sidecar of the online path (``LATEST``, the stream's
    high-water mark) is written so. On a remote store one object write is
    already all or nothing."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    if is_remote(path):
        with open_stream(path, "wb") as f:
            f.write(data)
        return
    d = os.path.dirname(path) or "."
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


def append(path: str, data) -> None:
    """Append ``data`` (str or bytes) to a (possibly remote) file. Locally
    an fsynced append; an object store has no append, so the object is
    rewritten whole in one write."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    if is_remote(path):
        old = read_bytes(path) if exists(path) else b""
        write_atomic(path, old + data)
        return
    with open(path, "ab") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def join(base: str, *parts: str) -> str:
    """Path join that keeps a remote base's URI: object stores always use
    '/', whatever the platform's separator."""
    if is_remote(base):
        out = base.rstrip("/")
        for p in parts:
            out += "/" + str(p).strip("/")
        return out
    return os.path.join(base, *parts)


def normalize_dir(path: str) -> str:
    """Absolute form of a local path; a remote URI passes through without
    its trailing '/' (``os.path.abspath`` would mangle it into
    ``/cwd/gs:/bucket/...``)."""
    if is_remote(path):
        return path.rstrip("/")
    return os.path.abspath(path)


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
    return ResilientStream(path, policy=policy, on_retry=on_retry)
