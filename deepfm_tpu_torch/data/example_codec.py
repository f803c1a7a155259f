"""Minimal ``tf.train.Example`` wire-format codec for the CTR schema.

The port's copy of the CTR subset of ``deepfm_tpu.data.example_codec``:
on-disk schema ``{label: float, ids: int64[F], values: float[F]}``, with
the legacy ``feat_ids`` / ``feat_vals`` keys accepted on read, and two
optional extensions: a second task's ``label2`` float (multi-task input)
and the ragged user-history pair ``hist_ids`` int64[L] / ``hist_vals``
float[L] (sequence models), any length including zero. Records written
without them are byte-identical to the single-label encoding.

Wire format facts used (protobuf encoding spec):
  Example        { Features features = 1; }
  Features       { map<string, Feature> feature = 1; }   // map entry: key=1, value=2
  Feature        { oneof { BytesList bytes_list = 1; FloatList float_list = 2;
                           Int64List int64_list = 3; } }
  FloatList      { repeated float value = 1 [packed]; }
  Int64List      { repeated int64 value = 1 [packed]; }
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

LABEL_KEY = "label"
IDS_KEY = "ids"
VALS_KEY = "values"
LEGACY_IDS_KEY = "feat_ids"
LEGACY_VALS_KEY = "feat_vals"
# Optional second task label (e.g. conversion for --tasks ctr,cvr); decode
# defaults it to 0.0.
LABEL2_KEY = "label2"
# Optional ragged user-history pair, decoded into fixed [max_len] id/mask
# columns (decode_ctr_example_hist; the native dfm_decode_ctr_hist).
HIST_IDS_KEY = "hist_ids"
HIST_VALS_KEY = "hist_vals"


def write_varint(n: int, out: bytearray) -> None:
    if n < 0:
        n &= (1 << 64) - 1  # two's complement, 64-bit
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _write_len_delimited(field_number: int, payload: bytes,
                         out: bytearray) -> None:
    write_varint((field_number << 3) | 2, out)
    write_varint(len(payload), out)
    out += payload


def encode_feature(value, kind: str) -> bytes:
    """Encode one Feature message; ``kind`` is ``float``, ``int64`` or
    ``bytes`` (a list of byte strings)."""
    inner = bytearray()
    if kind == "float":
        _write_len_delimited(1, np.asarray(value, dtype="<f4").tobytes(),
                             inner)
        field = 2
    elif kind == "int64":
        payload = bytearray()
        for v in np.asarray(value, dtype=np.int64).tolist():
            write_varint(v, payload)
        _write_len_delimited(1, bytes(payload), inner)
        field = 3
    elif kind == "bytes":
        for v in value:
            _write_len_delimited(1, v, inner)
        field = 1
    else:
        raise ValueError(f"unknown feature kind {kind!r}")
    out = bytearray()
    _write_len_delimited(field, bytes(inner), out)
    return bytes(out)


def encode_example(features: Dict[str, Tuple[np.ndarray, str]]) -> bytes:
    """Serialize an Example. ``features`` maps name -> (value, kind), kind
    ``float`` or ``int64``."""
    feat_map = bytearray()
    for name, (value, kind) in features.items():
        entry = bytearray()
        _write_len_delimited(1, name.encode("utf-8"), entry)
        _write_len_delimited(2, encode_feature(value, kind), entry)
        _write_len_delimited(1, bytes(entry), feat_map)
    out = bytearray()
    _write_len_delimited(1, bytes(feat_map), out)
    return bytes(out)


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        n, pos = read_varint(buf, pos)
        pos += n
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _decode_float_list(buf: bytes) -> np.ndarray:
    pos, end = 0, len(buf)
    chunks: List[np.ndarray] = []
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:  # packed
            n, pos = read_varint(buf, pos)
            chunks.append(np.frombuffer(buf, dtype="<f4", count=n // 4,
                                        offset=pos))
            pos += n
        elif field == 1 and wt == 5:  # unpacked fixed32
            chunks.append(np.frombuffer(buf, dtype="<f4", count=1, offset=pos))
            pos += 4
        else:
            pos = _skip_field(buf, pos, wt)
    if not chunks:
        return np.zeros((0,), np.float32)
    return np.concatenate(chunks) if len(chunks) > 1 else chunks[0].copy()


def _decode_int64_list(buf: bytes) -> np.ndarray:
    pos, end = 0, len(buf)
    vals: List[int] = []
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:  # packed
            n, pos = read_varint(buf, pos)
            stop = pos + n
            while pos < stop:
                v, pos = read_varint(buf, pos)
                if v >= 1 << 63:
                    v -= 1 << 64
                vals.append(v)
        elif field == 1 and wt == 0:
            v, pos = read_varint(buf, pos)
            if v >= 1 << 63:
                v -= 1 << 64
            vals.append(v)
        else:
            pos = _skip_field(buf, pos, wt)
    return np.asarray(vals, dtype=np.int64)


def _decode_bytes_list(buf: bytes) -> List[bytes]:
    pos, end = 0, len(buf)
    vals: List[bytes] = []
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            n, pos = read_varint(buf, pos)
            vals.append(buf[pos:pos + n])
            pos += n
        else:
            pos = _skip_field(buf, pos, wt)
    return vals


def decode_feature(buf: bytes):
    """One Feature message -> (kind, values): ``float``, ``int64`` or
    ``bytes`` (an empty message reads as no bytes)."""
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt != 2:
            pos = _skip_field(buf, pos, wt)
            continue
        n, pos = read_varint(buf, pos)
        payload = buf[pos:pos + n]
        pos += n
        if field == 1:
            return "bytes", _decode_bytes_list(payload)
        if field == 2:
            return "float", _decode_float_list(payload)
        if field == 3:
            return "int64", _decode_int64_list(payload)
    return "bytes", []


def _decode_feature(buf: bytes):
    """One Feature message -> its float or int64 values (None for bytes)."""
    kind, value = decode_feature(buf)
    return None if kind == "bytes" else value


def decode_example(buf: bytes) -> Dict[str, np.ndarray]:
    """Parse a serialized Example -> {name: values}."""
    out: Dict[str, np.ndarray] = {}
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field != 1 or wt != 2:  # not Example.features
            pos = _skip_field(buf, pos, wt)
            continue
        n, pos = read_varint(buf, pos)
        fpos, fend = pos, pos + n
        pos = fend
        while fpos < fend:
            ftag, fpos = read_varint(buf, fpos)
            ffield, fwt = ftag >> 3, ftag & 7
            if ffield != 1 or fwt != 2:  # not a map entry
                fpos = _skip_field(buf, fpos, fwt)
                continue
            en, fpos = read_varint(buf, fpos)
            epos, eend = fpos, fpos + en
            fpos = eend
            key = b""
            feat = b""
            while epos < eend:
                etag, epos = read_varint(buf, epos)
                efield, ewt = etag >> 3, etag & 7
                if ewt != 2:
                    epos = _skip_field(buf, epos, ewt)
                    continue
                vn, epos = read_varint(buf, epos)
                if efield == 1:
                    key = buf[epos:epos + vn]
                elif efield == 2:
                    feat = buf[epos:epos + vn]
                epos += vn
            out[key.decode("utf-8")] = _decode_feature(feat)
    return out


def encode_ctr_example(label: float, ids: np.ndarray, vals: np.ndarray,
                       label2: Optional[float] = None,
                       hist_ids: Optional[np.ndarray] = None,
                       hist_vals: Optional[np.ndarray] = None) -> bytes:
    """Encode the reference CTR schema ``{label, ids, values}``, plus
    ``label2`` when given and the ``hist_ids``/``hist_vals`` pair when
    ``hist_ids`` is given (``hist_vals`` defaults to ones). With every
    optional None the bytes are the single-label encoding's."""
    features = {
        LABEL_KEY: (np.asarray([label], np.float32), "float"),
        IDS_KEY: (np.asarray(ids, np.int64), "int64"),
        VALS_KEY: (np.asarray(vals, np.float32), "float"),
    }
    if label2 is not None:
        features[LABEL2_KEY] = (np.asarray([label2], np.float32), "float")
    if hist_ids is not None:
        features[HIST_IDS_KEY] = (np.asarray(hist_ids, np.int64), "int64")
        hv = hist_vals if hist_vals is not None else np.ones(
            len(np.asarray(hist_ids)), np.float32)
        features[HIST_VALS_KEY] = (np.asarray(hv, np.float32), "float")
    return encode_example(features)


def decode_ctr_example(buf: bytes, field_size: int
                       ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Decode one CTR Example, checking the fixed ``field_size``."""
    feats = decode_example(buf)
    try:
        label = feats[LABEL_KEY]
        ids = feats[IDS_KEY] if IDS_KEY in feats else feats[LEGACY_IDS_KEY]
        vals = (feats[VALS_KEY] if VALS_KEY in feats
                else feats[LEGACY_VALS_KEY])
    except KeyError:
        raise ValueError(
            "Example is missing CTR schema keys: found "
            f"{sorted(feats)}, need 'label' plus 'ids'/'values' "
            "(reference schema) or 'feat_ids'/'feat_vals' (legacy)") from None
    ids = np.asarray(ids, np.int64)
    vals = np.asarray(vals, np.float32)
    if ids.shape[0] != field_size or vals.shape[0] != field_size:
        raise ValueError(
            f"expected field_size={field_size}, got ids={ids.shape[0]} "
            f"vals={vals.shape[0]}")
    return float(np.asarray(label, np.float32)[0]), ids, vals


def decode_ctr_example2(buf: bytes, field_size: int
                        ) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Two-label decode: ``(label, label2, ids, vals)``, ``label2`` 0.0
    when the key is absent. The Python mirror of the native
    ``dfm_decode_ctr2_ex``."""
    feats = decode_example(buf)
    label, ids, vals = decode_ctr_example(buf, field_size)
    label2 = 0.0
    if LABEL2_KEY in feats:
        l2 = np.asarray(feats[LABEL2_KEY], np.float32)
        if l2.shape[0] != 1:
            raise ValueError(
                f"'label2' must be a single float, got {l2.shape[0]} values")
        label2 = float(l2[0])
    return label, label2, ids, vals


def decode_ctr_example_hist(
        buf: bytes, field_size: int, max_len: int
) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """History decode: ``(label, ids, vals, hist_ids [max_len] int32,
    hist_vals [max_len] float32, hist_len)``, the ragged pair zero-padded
    to ``max_len`` and truncated past it (``hist_len = min(actual,
    max_len)``); a record without the pair has an empty history, and one
    whose two lists differ in length is a schema error. The Python mirror
    of the native ``dfm_decode_ctr_hist``."""
    feats = decode_example(buf)
    label, ids, vals = decode_ctr_example(buf, field_size)
    h_ids = np.asarray(feats[HIST_IDS_KEY], np.int64) \
        if HIST_IDS_KEY in feats else np.zeros((0,), np.int64)
    h_vals = np.asarray(feats[HIST_VALS_KEY], np.float32) \
        if HIST_VALS_KEY in feats else np.zeros((0,), np.float32)
    if h_ids.shape[0] != h_vals.shape[0]:
        raise ValueError(
            f"history length mismatch: {h_ids.shape[0]} hist_ids vs "
            f"{h_vals.shape[0]} hist_vals")
    n = min(h_ids.shape[0], int(max_len))
    out_ids = np.zeros((max_len,), np.int32)
    out_vals = np.zeros((max_len,), np.float32)
    out_ids[:n] = h_ids[:n].astype(np.int32)
    out_vals[:n] = h_vals[:n]
    return label, ids, vals, out_ids, out_vals, n
