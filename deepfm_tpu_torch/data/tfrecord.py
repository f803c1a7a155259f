"""TFRecord container I/O for local files: framing + masked CRC32C.

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


def iter_records_from_stream(stream: BinaryIO, *, verify_crc: bool = True,
                             path: str = "") -> Iterator[bytes]:
    """Sequential record iterator over a byte stream (never seeks). A
    corrupt or truncated frame raises ``IOError`` naming ``path`` and the
    byte offset of the frame."""
    label = path or "<stream>"
    pos = 0
    while True:
        header = stream.read(12)
        if not header:
            return
        if len(header) < 12:
            raise IOError(f"corrupt TFRecord: truncated TFRecord header in "
                          f"{label} at byte {pos}")
        (length,) = struct.unpack("<Q", header[:8])
        (len_crc,) = struct.unpack("<I", header[8:12])
        if verify_crc and masked_crc32c(header[:8]) != len_crc:
            raise IOError(f"corrupt TFRecord: length CRC mismatch in {label} "
                          f"at byte {pos}")
        payload = stream.read(length + 4)
        if len(payload) < length + 4:
            raise IOError(f"corrupt TFRecord: truncated TFRecord payload in "
                          f"{label} at byte {pos}")
        data, (data_crc,) = payload[:length], struct.unpack(
            "<I", payload[length:])
        if verify_crc and masked_crc32c(data) != data_crc:
            raise IOError(f"corrupt TFRecord: data CRC mismatch in {label} "
                          f"at byte {pos}")
        pos += 12 + length + 4
        yield data


def iter_records(path: str, *, verify_crc: bool = True) -> Iterator[bytes]:
    """Iterate the records of a local TFRecord file."""
    with open(path, "rb", buffering=1 << 20) as f:
        yield from iter_records_from_stream(f, verify_crc=verify_crc,
                                            path=path)

