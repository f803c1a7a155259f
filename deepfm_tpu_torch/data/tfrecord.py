"""TFRecord container I/O for local files: framing + masked CRC32C, and
the Python framer that locates a bad frame and applies the bad-record
policy.

The port's copy of ``deepfm_tpu.data.tfrecord`` (local paths only). The
on-disk format is TensorFlow's TFRecord:

    uint64  length (little-endian)
    uint32  masked_crc32c(length bytes)
    bytes   data[length]
    uint32  masked_crc32c(data)

CRC32C (Castagnoli, reflected poly 0x82F63B78) is pure Python, slice-by-8.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Iterator, List, Optional

import numpy as np

_CRC_TABLES8: Optional[List[List[int]]] = None


def _crc32c_tables8() -> List[List[int]]:
    """Slice-by-8 tables (plain int lists — faster than np scalars here)."""
    global _CRC_TABLES8
    if _CRC_TABLES8 is None:
        poly = 0x82F63B78
        t0 = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            t0.append(crc)
        tables = [t0]
        for _ in range(7):
            prev = tables[-1]
            tables.append([t0[v & 0xFF] ^ (v >> 8) for v in prev])
        _CRC_TABLES8 = tables
    return _CRC_TABLES8


def crc32c(data: bytes) -> int:
    """Pure-Python CRC32C, slice-by-8: one Python iteration per 8 bytes."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _crc32c_tables8()
    c = 0xFFFFFFFF
    n8 = len(data) >> 3
    if n8:
        for (w,) in struct.iter_unpack("<Q", memoryview(data)[:n8 * 8]):
            w ^= c
            c = (t7[w & 0xFF] ^ t6[(w >> 8) & 0xFF]
                 ^ t5[(w >> 16) & 0xFF] ^ t4[(w >> 24) & 0xFF]
                 ^ t3[(w >> 32) & 0xFF] ^ t2[(w >> 40) & 0xFF]
                 ^ t1[(w >> 48) & 0xFF] ^ t0[(w >> 56) & 0xFF])
    for b in memoryview(data)[n8 * 8:]:
        c = (c >> 8) ^ t0[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


class TFRecordWriter:
    """Append serialized records to a local TFRecord file."""

    def __init__(self, path: str):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f: Optional[BinaryIO] = open(path, "wb")

    def write(self, record: bytes) -> None:
        assert self._f is not None, "writer closed"
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _frame_fault(policy, path: str, offset: int, reason: str, *,
                 nbytes: int = 0, truncated: bool = False) -> None:
    """Route one bad frame through the policy, or raise with path+offset."""
    if policy is not None:
        policy.bad_record(path, offset, reason, nbytes=nbytes,
                          truncated=truncated)
        return
    label = path or "<stream>"
    raise IOError(f"corrupt TFRecord: {reason} in {label} at byte {offset}")


def iter_records_from_stream(stream: BinaryIO, *, verify_crc: bool = True,
                             path: str = "", policy=None) -> Iterator[bytes]:
    """Sequential record iterator over a byte stream (never seeks).

    ``path`` labels errors with the source and the absolute byte offset of
    the bad frame; ``policy`` (a ``health.BadRecordPolicy``) turns raises
    into counted skips: a data-CRC mismatch skips that record, while a
    length-CRC mismatch or a truncated frame discards the rest of the
    stream (framing cannot resync)."""
    pos = 0
    while True:
        header = stream.read(12)
        if not header:
            return
        if len(header) < 12:
            _frame_fault(policy, path, pos, "truncated TFRecord header",
                         nbytes=len(header), truncated=True)
            return
        (length,) = struct.unpack("<Q", header[:8])
        (len_crc,) = struct.unpack("<I", header[8:12])
        if verify_crc and masked_crc32c(header[:8]) != len_crc:
            _frame_fault(policy, path, pos,
                         "length CRC mismatch (cannot resync; "
                         "discarding rest of file)", truncated=True)
            return
        payload = stream.read(length + 4)
        if len(payload) < length + 4:
            _frame_fault(policy, path, pos, "truncated TFRecord payload",
                         nbytes=12 + len(payload), truncated=True)
            return
        data, (data_crc,) = payload[:length], struct.unpack(
            "<I", payload[length:])
        if verify_crc and masked_crc32c(data) != data_crc:
            _frame_fault(policy, path, pos, "data CRC mismatch",
                         nbytes=12 + length + 4)
            pos += 12 + length + 4
            continue
        pos += 12 + length + 4
        yield data


def iter_records(path: str, *, verify_crc: bool = True, policy=None,
                 resilient: bool = False, retry_policy=None,
                 on_retry=None) -> Iterator[bytes]:
    """Iterate the records of a local TFRecord file. ``resilient=True``
    reads through ``fileio.ResilientStream``, so transient mid-file read
    errors heal by reopen-and-seek."""
    from . import fileio  # noqa: PLC0415 (import cycle at module load)
    if resilient:
        with fileio.open_resilient(path, policy=retry_policy,
                                   on_retry=on_retry) as f:
            yield from iter_records_from_stream(
                f, verify_crc=verify_crc, path=path, policy=policy)
        return
    with open(fileio._local(path), "rb", buffering=1 << 20) as f:
        yield from iter_records_from_stream(
            f, verify_crc=verify_crc, path=path, policy=policy)


def split_record_frames(buf: bytes, *, verify_crc: bool = False,
                        path: str = "") -> List[bytes]:
    """Split a whole-file byte buffer into record payloads."""
    label = path or "<buffer>"
    out: List[bytes] = []
    pos, end = 0, len(buf)
    while pos < end:
        if end - pos < 12:
            raise IOError(f"truncated TFRecord header in {label} "
                          f"at byte {pos}")
        (length,) = struct.unpack_from("<Q", buf, pos)
        if verify_crc:
            (len_crc,) = struct.unpack_from("<I", buf, pos + 8)
            if masked_crc32c(buf[pos:pos + 8]) != len_crc:
                raise IOError(f"corrupt TFRecord: length CRC mismatch in "
                              f"{label} at byte {pos}")
        pos += 12
        if end - pos < length + 4:
            raise IOError(f"truncated TFRecord payload in {label} "
                          f"at byte {pos - 12}")
        data = buf[pos:pos + length]
        if verify_crc:
            (data_crc,) = struct.unpack_from("<I", buf, pos + length)
            if masked_crc32c(data) != data_crc:
                raise IOError(f"corrupt TFRecord: data CRC mismatch in "
                              f"{label} at byte {pos - 12}")
        out.append(data)
        pos += length + 4
    return out


def scan_frames_partial(buf, *, verify_crc: bool = True, final: bool = False,
                        base_offset: int = 0, path: str = "", policy=None):
    """Python counterpart of ``native.loader.split_frames_partial`` with the
    bad-record policy.

    Frames as many complete records of ``buf`` as it can and returns
    ``(offsets, lengths, consumed, abort)``: int64 payload spans within
    ``buf``, the bytes fully processed (skipped bad records count as
    consumed), and whether framing cannot go on past ``consumed``
    (length-CRC corruption or, when ``final``, a truncated tail), in which
    case the caller stops reading the stream. ``base_offset`` is the
    absolute offset of ``buf[0]``, so errors and health entries carry true
    file offsets. The pipeline calls this only when the native framer
    rejects a chunk."""
    offsets: List[int] = []
    lengths: List[int] = []
    pos, end = 0, len(buf)
    abort = False
    while True:
        avail = end - pos
        if avail < 12:
            if final and avail > 0:
                _frame_fault(policy, path, base_offset + pos,
                             "truncated TFRecord header", nbytes=avail,
                             truncated=True)
                pos, abort = end, True
            break
        (length,) = struct.unpack_from("<Q", buf, pos)
        if verify_crc:
            (len_crc,) = struct.unpack_from("<I", buf, pos + 8)
            if masked_crc32c(bytes(buf[pos:pos + 8])) != len_crc:
                _frame_fault(policy, path, base_offset + pos,
                             "length CRC mismatch (cannot resync; "
                             "discarding rest of file)", truncated=True)
                pos, abort = end, True
                break
        total = 12 + length + 4
        if avail < total:
            if final:
                _frame_fault(policy, path, base_offset + pos,
                             "truncated TFRecord payload", nbytes=avail,
                             truncated=True)
                pos, abort = end, True
            break
        if verify_crc:
            data = bytes(buf[pos + 12:pos + 12 + length])
            (data_crc,) = struct.unpack_from("<I", buf, pos + 12 + length)
            if masked_crc32c(data) != data_crc:
                _frame_fault(policy, path, base_offset + pos,
                             "data CRC mismatch", nbytes=total)
                pos += total
                continue
        offsets.append(pos + 12)
        lengths.append(length)
        pos += total
    return (np.asarray(offsets, dtype=np.int64),
            np.asarray(lengths, dtype=np.int64), pos, abort)
