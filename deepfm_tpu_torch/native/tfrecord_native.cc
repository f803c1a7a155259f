// Native TFRecord frame splitter + tf.train.Example CTR decoder.
//
// TPU-native equivalent of the reference's two C++ data dependencies:
// the TFRecord/proto codec inside TensorFlow (X4) and the PipeModeDataset
// FIFO reader's parsing core (X3). The host CPU decode is the input
// pipeline's hot loop (reference decodes with vectorized tf.parse_example
// after .batch(), 1-ps-cpu/...py:119-128); this library does the same work —
// record framing, CRC32C integrity, protobuf wire parsing into fixed-shape
// arrays — in one pass at C speed, exposed to Python via ctypes (no pybind
// dependency).
//
// Build: g++ -O3 -march=native -shared -fPIC tfrecord_native.cc -o libtfrecord.so
//
// On-disk schema, matching the reference converter (tools/libsvm_to_tfrecord.py:25-33):
//   Example{ label: float_list[1], ids: int64_list[F], values: float_list[F] }
// The legacy aliases feat_ids/feat_vals (written by pre-r3 versions of this
// repo) are accepted on read.

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slice-by-8 software implementation.
// ---------------------------------------------------------------------------

uint32_t g_crc_table[8][256];
bool g_crc_init = false;

void init_crc_tables() {
  if (g_crc_init) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    g_crc_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = g_crc_table[0][i];
    for (int k = 1; k < 8; ++k) {
      crc = g_crc_table[0][crc & 0xFF] ^ (crc >> 8);
      g_crc_table[k][i] = crc;
    }
  }
  g_crc_init = true;
}

uint32_t crc32c(const uint8_t* data, size_t len) {
  uint32_t crc = 0xFFFFFFFFu;
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    word ^= crc;
    crc = g_crc_table[7][word & 0xFF] ^ g_crc_table[6][(word >> 8) & 0xFF] ^
          g_crc_table[5][(word >> 16) & 0xFF] ^ g_crc_table[4][(word >> 24) & 0xFF] ^
          g_crc_table[3][(word >> 32) & 0xFF] ^ g_crc_table[2][(word >> 40) & 0xFF] ^
          g_crc_table[1][(word >> 48) & 0xFF] ^ g_crc_table[0][(word >> 56) & 0xFF];
    data += 8;
    len -= 8;
  }
  while (len--) crc = g_crc_table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

inline uint32_t masked_crc32c(const uint8_t* data, size_t len) {
  uint32_t crc = crc32c(data, len);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// Protobuf wire helpers.
// ---------------------------------------------------------------------------

// Reads a varint; returns false on overrun/malformed.
inline bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (p < end && shift <= 63) {
    uint8_t b = *p++;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  // Loop exits after consuming the 10th byte (shift 0..63 inclusive = 10
  // iterations, covering 64-bit two's-complement varints) or on overrun.
  return false;
}

inline bool skip_field(const uint8_t*& p, const uint8_t* end, uint32_t wire) {
  uint64_t tmp;
  switch (wire) {
    case 0: return read_varint(p, end, &tmp);
    case 1: if (end - p < 8) return false; p += 8; return true;
    case 2:
      if (!read_varint(p, end, &tmp) || static_cast<uint64_t>(end - p) < tmp)
        return false;
      p += tmp;
      return true;
    case 5: if (end - p < 4) return false; p += 4; return true;
    default: return false;
  }
}

// Parse FloatList payload -> out[0..cap); returns count or -1.
long parse_float_list(const uint8_t* p, const uint8_t* end, float* out, long cap) {
  long n = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return -1;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {  // packed
      uint64_t len;
      if (!read_varint(p, end, &len) || static_cast<uint64_t>(end - p) < len)
        return -1;
      long cnt = len / 4;
      if (n + cnt > cap) return -1;
      std::memcpy(out + n, p, cnt * 4);
      n += cnt;
      p += len;
    } else if (field == 1 && wire == 5) {  // unpacked
      if (end - p < 4 || n >= cap) return -1;
      std::memcpy(out + n, p, 4);
      ++n;
      p += 4;
    } else {
      if (!skip_field(p, end, wire)) return -1;
    }
  }
  return n;
}

// Parse Int64List payload -> out[0..cap) as int32 (CTR ids fit); returns count or -1.
long parse_int64_list(const uint8_t* p, const uint8_t* end, int32_t* out, long cap) {
  long n = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return -1;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {  // packed
      uint64_t len;
      if (!read_varint(p, end, &len) || static_cast<uint64_t>(end - p) < len)
        return -1;
      const uint8_t* stop = p + len;
      while (p < stop) {
        uint64_t v;
        if (!read_varint(p, stop, &v) || n >= cap) return -1;
        out[n++] = static_cast<int32_t>(static_cast<int64_t>(v));
      }
    } else if (field == 1 && wire == 0) {
      uint64_t v;
      if (!read_varint(p, end, &v) || n >= cap) return -1;
      out[n++] = static_cast<int32_t>(static_cast<int64_t>(v));
    } else {
      if (!skip_field(p, end, wire)) return -1;
    }
  }
  return n;
}

// Truncating variants for ragged history lists: write at most cap entries
// but return the ACTUAL element count (which may exceed cap — the caller
// clamps). Only malformed wire is an error (-1); overflow is silent
// truncation, matching the fixed [max_len] history contract.
long parse_float_list_trunc(const uint8_t* p, const uint8_t* end, float* out,
                            long cap) {
  long n = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return -1;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {  // packed
      uint64_t len;
      if (!read_varint(p, end, &len) || static_cast<uint64_t>(end - p) < len)
        return -1;
      long cnt = len / 4;
      long keep = (n < cap) ? ((cnt < cap - n) ? cnt : cap - n) : 0;
      if (keep > 0) std::memcpy(out + n, p, keep * 4);
      n += cnt;
      p += len;
    } else if (field == 1 && wire == 5) {  // unpacked
      if (end - p < 4) return -1;
      if (n < cap) std::memcpy(out + n, p, 4);
      ++n;
      p += 4;
    } else {
      if (!skip_field(p, end, wire)) return -1;
    }
  }
  return n;
}

long parse_int64_list_trunc(const uint8_t* p, const uint8_t* end, int32_t* out,
                            long cap) {
  long n = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return -1;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {  // packed
      uint64_t len;
      if (!read_varint(p, end, &len) || static_cast<uint64_t>(end - p) < len)
        return -1;
      const uint8_t* stop = p + len;
      while (p < stop) {
        uint64_t v;
        if (!read_varint(p, stop, &v)) return -1;
        if (n < cap) out[n] = static_cast<int32_t>(static_cast<int64_t>(v));
        ++n;
      }
    } else if (field == 1 && wire == 0) {
      uint64_t v;
      if (!read_varint(p, end, &v)) return -1;
      if (n < cap) out[n] = static_cast<int32_t>(static_cast<int64_t>(v));
      ++n;
    } else {
      if (!skip_field(p, end, wire)) return -1;
    }
  }
  return n;
}

struct KeyRef { const uint8_t* p; uint64_t len; };

inline bool key_is(const KeyRef& k, const char* s) {
  size_t sl = std::strlen(s);
  return k.len == sl && std::memcmp(k.p, s, sl) == 0;
}

// Parse one serialized Example. Returns 0 ok, negative error. label2 (when
// non-null) receives the optional "label2" float key, defaulting to 0.0f
// when the key is absent — single-label files stay decodable as multi-task
// input; existing callers pass nullptr and are untouched. hist_ids/hist_vals
// (when non-null, sized [max_hist]) receive the optional ragged
// "hist_ids"/"hist_vals" pair zero-padded and silently truncated to
// max_hist, with *hist_len = min(actual, max_hist); both keys absent decodes
// as an empty history. One key without the other, or differing lengths, is a
// schema error (-27).
long parse_ctr_example(const uint8_t* p, const uint8_t* end, long field_size,
                       float* label, int32_t* ids, float* vals,
                       float* label2 = nullptr, long max_hist = 0,
                       int32_t* hist_ids = nullptr, float* hist_vals = nullptr,
                       int32_t* hist_len = nullptr) {
  bool got_label = false, got_ids = false, got_vals = false;
  if (label2) *label2 = 0.0f;
  long hist_ids_n = 0, hist_vals_n = 0;
  if (hist_ids) std::memset(hist_ids, 0, max_hist * sizeof(int32_t));
  if (hist_vals) std::memset(hist_vals, 0, max_hist * sizeof(float));
  if (hist_len) *hist_len = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return -10;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field != 1 || wire != 2) {  // not Example.features
      if (!skip_field(p, end, wire)) return -10;
      continue;
    }
    uint64_t flen;
    if (!read_varint(p, end, &flen) || static_cast<uint64_t>(end - p) < flen)
      return -10;
    const uint8_t* fp = p;
    const uint8_t* fend = p + flen;
    p = fend;
    while (fp < fend) {  // Features.feature map entries
      uint64_t ftag;
      if (!read_varint(fp, fend, &ftag)) return -11;
      if ((ftag >> 3) != 1 || (ftag & 7) != 2) {
        if (!skip_field(fp, fend, ftag & 7)) return -11;
        continue;
      }
      uint64_t elen;
      if (!read_varint(fp, fend, &elen) || static_cast<uint64_t>(fend - fp) < elen)
        return -11;
      const uint8_t* ep = fp;
      const uint8_t* eend = fp + elen;
      fp = eend;
      KeyRef key{nullptr, 0};
      const uint8_t* feat_p = nullptr;
      uint64_t feat_len = 0;
      while (ep < eend) {  // map entry: key=1, value=2
        uint64_t etag;
        if (!read_varint(ep, eend, &etag)) return -12;
        uint32_t ef = etag >> 3, ew = etag & 7;
        if (ew != 2) {
          if (!skip_field(ep, eend, ew)) return -12;
          continue;
        }
        uint64_t vlen;
        if (!read_varint(ep, eend, &vlen) || static_cast<uint64_t>(eend - ep) < vlen)
          return -12;
        if (ef == 1) { key.p = ep; key.len = vlen; }
        else if (ef == 2) { feat_p = ep; feat_len = vlen; }
        ep += vlen;
      }
      if (!key.p || !feat_p) continue;
      // Feature: one length-delimited sub-message (1:bytes 2:float 3:int64)
      const uint8_t* vp = feat_p;
      const uint8_t* vend = feat_p + feat_len;
      uint64_t vtag;
      if (!read_varint(vp, vend, &vtag)) return -13;
      uint32_t vfield = vtag >> 3;
      if ((vtag & 7) != 2) continue;
      uint64_t plen;
      if (!read_varint(vp, vend, &plen) || static_cast<uint64_t>(vend - vp) < plen)
        return -13;
      const uint8_t* payload = vp;
      const uint8_t* pend = vp + plen;
      if (key_is(key, "label") && vfield == 2) {
        if (parse_float_list(payload, pend, label, 1) != 1) return -20;
        got_label = true;
      } else if (label2 && key_is(key, "label2") && vfield == 2) {
        if (parse_float_list(payload, pend, label2, 1) != 1) return -24;
      } else if ((key_is(key, "ids") || key_is(key, "feat_ids")) &&
                 vfield == 3) {
        if (parse_int64_list(payload, pend, ids, field_size) != field_size)
          return -21;
        got_ids = true;
      } else if ((key_is(key, "values") || key_is(key, "feat_vals")) &&
                 vfield == 2) {
        if (parse_float_list(payload, pend, vals, field_size) != field_size)
          return -22;
        got_vals = true;
      } else if (hist_ids && key_is(key, "hist_ids") && vfield == 3) {
        hist_ids_n = parse_int64_list_trunc(payload, pend, hist_ids, max_hist);
        if (hist_ids_n < 0) return -25;
      } else if (hist_vals && key_is(key, "hist_vals") && vfield == 2) {
        hist_vals_n = parse_float_list_trunc(payload, pend, hist_vals, max_hist);
        if (hist_vals_n < 0) return -26;
      }
    }
  }
  if (hist_ids) {
    if (hist_ids_n != hist_vals_n) return -27;
    if (hist_len) {
      *hist_len = static_cast<int32_t>(
          hist_ids_n < max_hist ? hist_ids_n : max_hist);
    }
  }
  return (got_label && got_ids && got_vals) ? 0 : -23;
}

}  // namespace

extern "C" {

// Split TFRecord frames in buf[0..len). Fills offsets/lengths (payload only,
// excluding framing) up to max_records. verify_crc: 0 none, 1 both CRCs.
// allow_partial: 1 = stop cleanly at an incomplete trailing record (chunked
// streaming; *consumed tells the caller how many bytes were fully framed so
// it can carry the tail into the next chunk). 0 = truncation is an error.
// Returns record count, or negative: -1 truncated, -2 crc mismatch,
// -3 capacity exceeded (only when allow_partial=0).
long dfm_split_frames_ex(const uint8_t* buf, long len, long verify_crc,
                         long allow_partial, long max_records,
                         long* offsets, long* lengths, long* consumed) {
  init_crc_tables();
  long n = 0;
  long pos = 0;
  while (pos < len) {
    if (len - pos < 12) {
      if (allow_partial) break;
      return -1;
    }
    uint64_t rec_len;
    std::memcpy(&rec_len, buf + pos, 8);
    if (verify_crc) {
      uint32_t stored;
      std::memcpy(&stored, buf + pos + 8, 4);
      if (masked_crc32c(buf + pos, 8) != stored) return -2;
    }
    // avail/rec_len compared without addition: rec_len + 4 could wrap uint64
    // on a corrupt length field and defeat the bounds check.
    uint64_t avail = static_cast<uint64_t>(len - pos - 12);
    if (avail < 4 || rec_len > avail - 4) {
      if (allow_partial) break;  // record continues past this chunk
      return -1;
    }
    if (verify_crc) {
      uint32_t stored;
      std::memcpy(&stored, buf + pos + 12 + rec_len, 4);
      if (masked_crc32c(buf + pos + 12, rec_len) != stored) return -2;
    }
    if (n >= max_records) {
      if (allow_partial) break;
      return -3;
    }
    offsets[n] = pos + 12;
    lengths[n] = static_cast<long>(rec_len);
    ++n;
    pos += 12 + rec_len + 4;
  }
  if (consumed) *consumed = pos;
  return n;
}

// Back-compat whole-buffer splitter (strict framing).
long dfm_split_frames(const uint8_t* buf, long len, long verify_crc,
                      long max_records, long* offsets, long* lengths) {
  return dfm_split_frames_ex(buf, len, verify_crc, /*allow_partial=*/0,
                             max_records, offsets, lengths, nullptr);
}

// Decode n CTR Examples addressed by (offsets, lengths) into fixed-shape
// outputs: labels[n], ids[n*field_size], vals[n*field_size].
// Returns 0, or -(100+i) error at record i; *err_detail (if non-null) holds
// the parse_ctr_example code for that record: -10..-13 malformed wire,
// -20/-21/-22 label/ids/values length != expected, -23 required key missing.
long dfm_decode_ctr_ex(const uint8_t* buf, const long* offsets,
                       const long* lengths, long n, long field_size,
                       float* labels, int32_t* ids, float* vals,
                       long* err_detail) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = buf + offsets[i];
    long rc = parse_ctr_example(p, p + lengths[i], field_size, labels + i,
                                ids + i * field_size, vals + i * field_size);
    if (rc != 0) {
      if (err_detail) *err_detail = rc;
      return -(100 + i);
    }
  }
  return 0;
}

// Back-compat entry without the error-detail out-param.
long dfm_decode_ctr(const uint8_t* buf, const long* offsets, const long* lengths,
                    long n, long field_size, float* labels, int32_t* ids,
                    float* vals) {
  return dfm_decode_ctr_ex(buf, offsets, lengths, n, field_size, labels, ids,
                           vals, nullptr);
}

// Two-label decode for multi-task training (--tasks ctr,cvr): additionally
// fills labels2[n] from the optional "label2" float key, 0.0 when absent.
// Error contract matches dfm_decode_ctr_ex, plus detail -24 for a malformed
// 'label2' (present but not a single float).
long dfm_decode_ctr2_ex(const uint8_t* buf, const long* offsets,
                        const long* lengths, long n, long field_size,
                        float* labels, float* labels2, int32_t* ids,
                        float* vals, long* err_detail) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = buf + offsets[i];
    long rc = parse_ctr_example(p, p + lengths[i], field_size, labels + i,
                                ids + i * field_size, vals + i * field_size,
                                labels2 + i);
    if (rc != 0) {
      if (err_detail) *err_detail = rc;
      return -(100 + i);
    }
  }
  return 0;
}

// History decode for sequence models: additionally fills the optional ragged
// "hist_ids"/"hist_vals" pair into fixed [n, max_hist] outputs, zero-padded
// and silently truncated past max_hist, with hist_len[i] = min(actual,
// max_hist). Records without history keys decode with hist_len 0. Error
// contract matches dfm_decode_ctr_ex, plus details -25/-26 for malformed
// hist_ids/hist_vals wire and -27 for a length-mismatched (or half-present)
// pair.
long dfm_decode_ctr_hist(const uint8_t* buf, const long* offsets,
                         const long* lengths, long n, long field_size,
                         long max_hist, float* labels, int32_t* ids,
                         float* vals, int32_t* hist_ids, float* hist_vals,
                         int32_t* hist_len, long* err_detail) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = buf + offsets[i];
    long rc = parse_ctr_example(p, p + lengths[i], field_size, labels + i,
                                ids + i * field_size, vals + i * field_size,
                                nullptr, max_hist, hist_ids + i * max_hist,
                                hist_vals + i * max_hist, hist_len + i);
    if (rc != 0) {
      if (err_detail) *err_detail = rc;
      return -(100 + i);
    }
  }
  return 0;
}

// Fused decode + shuffle scatter: decode record i straight into row dest[i]
// of the output arrays (the shuffle pool). Each record's field bytes are
// written exactly once, at their permuted destination — replacing the
// decode-then-scatter sequence (two full passes over the pool: one
// sequential write + one random-access copy) with a single pass whose only
// random access is the final store. The caller owns destination bounds
// (every dest[i] < pool rows) and disjointness across concurrent calls.
long dfm_decode_ctr_scatter(const uint8_t* buf, const long* offsets,
                            const long* lengths, long n, long field_size,
                            const long* dest, float* labels, int32_t* ids,
                            float* vals, long* err_detail) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = buf + offsets[i];
    const long d = dest[i];
    long rc = parse_ctr_example(p, p + lengths[i], field_size, labels + d,
                                ids + d * field_size, vals + d * field_size);
    if (rc != 0) {
      if (err_detail) *err_detail = rc;
      return -(100 + i);
    }
  }
  return 0;
}

// Fused decode->assemble over MANY framed chunk spans in one call: the
// whole pool drain (every raw chunk held since the last drain) decodes
// straight into the permuted rows of the preallocated transfer-layout
// output buffers — labels[P] (the [P,1] column of the emitted batch dict
// is the same contiguous floats), ids[P*field_size], vals[P*field_size].
// dest is the concatenated destination-row vector across chunks (chunk c's
// records use dest[base_c .. base_c+counts[c])). One ctypes crossing and
// one GIL release per drain instead of one per chunk: on a contended
// 1-core host each C call's GIL reacquisition can stall up to a switch
// interval behind the consumer thread, so fewer crossings is a real win,
// not just call-overhead accounting.
// Returns 0, or -(100+i) with i the record index WITHIN the failing chunk;
// *err_chunk (if non-null) holds that chunk's index and *err_detail the
// parse_ctr_example code (same contract as dfm_decode_ctr_ex).
long dfm_decode_ctr_assemble(const uint8_t* const* bufs,
                             const long* const* offsets,
                             const long* const* lengths,
                             const long* counts, long n_chunks,
                             long field_size, const long* dest,
                             float* labels, int32_t* ids, float* vals,
                             long* err_chunk, long* err_detail) {
  long base = 0;
  for (long c = 0; c < n_chunks; ++c) {
    const uint8_t* buf = bufs[c];
    const long* off = offsets[c];
    const long* len = lengths[c];
    const long n = counts[c];
    for (long i = 0; i < n; ++i) {
      const uint8_t* p = buf + off[i];
      const long d = dest[base + i];
      long rc = parse_ctr_example(p, p + len[i], field_size, labels + d,
                                  ids + d * field_size,
                                  vals + d * field_size);
      if (rc != 0) {
        if (err_chunk) *err_chunk = c;
        if (err_detail) *err_detail = rc;
        return -(100 + i);
      }
    }
    base += n;
  }
  return 0;
}

// Standalone CRC32C for tests.
uint32_t dfm_crc32c(const uint8_t* data, long len) {
  init_crc_tables();
  return crc32c(data, len);
}

}  // extern "C"
