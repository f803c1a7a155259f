// Sparse embedding plane for Hopper (sm_90a): the plan build, the gather
// forward with its position-order segment-sum backward, and the hot/cold
// tier's cache install.
//
// ---------------------------------------------------------------------------
// dfm_plan_build: replaces the TPU kernel deepfm_tpu/ops/pallas_embedding.py
// `_plan_kernel`. For ids int32 [N] with values in [0, rows] (the value rows
// is the fill id of masked positions):
//
//   touched[r] = r occurs in ids                      (r < rows)
//   rank[r]    = number of distinct ids below r       (r <= rows)
//   uids[j]    = the j-th distinct id, ascending; rows past the last one
//   inv[i]     = rank[ids[i]]
//
// which is jnp.unique(ids, size=N, fill_value=rows, return_inverse=True)
// bit for bit: a fill position's inv is the number of real uniques, and a
// present fill id lands in uids at that slot. An id outside [0, rows] is
// read as the fill id rows (marked at rows, inv = rank[rows]), so no id
// ever writes outside a buffer; the JAX package's callers never produce one
// (hash buckets are < rows, masked positions carry rows).
//
// Bound: device-memory bytes. Each input and output once: ids, uids, inv
// (4N bytes each), touched (rows bytes) and rank (4(rows+1) bytes). At the
// training shape of one hashed table (N = 39,936, rows = 262,144) that is
// about 1.79 MB, 0.53 us at 3.35 TB/s. A dozen integer operations per
// element: far below the card's operation rate.
//
// Design: the Pallas body is three serial loops over one VMEM-resident
// count vector. Here the same counting runs as parallel passes on one
// stream: (1) zero the [rows+1] marks (a memset into the rank buffer);
// (2) one thread per id marks it (idempotent stores of 1, so the order of
// the stores cannot matter) and sets its uids slot to the fill id; (3) a
// hand-written exclusive scan over rows+1 marks: each block scans a tile of
// 2048 (8 per thread, then a warp-shuffle scan of the thread sums), writes
// touched and the tile total; (4) one block scans the tile totals; (5) one
// thread per row adds its tile's offset to its rank and, when touched,
// writes uids[rank[r]] = r; (6) one thread per id writes inv[i] =
// rank[ids[i]]. Launch latency, not bytes, sets the time at these sizes:
// five launches and a memset for half a microsecond of traffic.
//
// ---------------------------------------------------------------------------
// dfm_take_fwd: replaces `_take_fwd_kernel`. out[p, :] = rows[inv[p], :]
// for rows [U, D] (float32 or bfloat16, copied as raw bits) and inv int32
// [N]; an inv outside [0, U) reads zeros.
//
// Bound: bytes, 4N + 2 N D itemsize with U = N: 10.38 MB at N = 39,936,
// D = 32, float32, 3.10 us at 3.35 TB/s; no arithmetic.
//
// Design: one thread per output element, e = p*D + c, so a warp writes one
// contiguous run of the output and reads one contiguous run of a row when
// D >= 32 (D = 1, fm_w, degenerates to one thread per position).
//
// ---------------------------------------------------------------------------
// dfm_take_bwd: replaces `_take_bwd_kernel`. d_rows[u, :] = sum over the
// positions p with inv[p] = u of g[p, :], SUMMED IN ASCENDING p STARTING
// FROM 0.0f: the order of the Pallas loop and of XLA's scatter-add, so the
// result equals the JAX package's gradient bit for bit. bfloat16 cotangents
// round the running sum to bfloat16 after each add, as the Pallas kernel's
// `out += g` in g's dtype does. No float atomics: their order changes from
// run to run.
//
// Input layout: the positions grouped by slot, ascending within a slot,
// as order int32 [N] and starts int32 [U+1] (slot u owns
// order[starts[u] .. starts[u+1])). The caller builds them once per plan
// with a stable sort of inv (integer bookkeeping, shared by every
// embedding name), and may leave out positions whose cotangent is always
// zero (a hashed table's masked positions, all in the fill slot): adding
// +-0.0 changes no float32 sum. Slots with no position are written as
// zeros.
//
// Bound: bytes, the same traffic as the forward (g and d_rows, N D itemsize
// each, plus inv): 3.10 us at the training shape, D = 32.
//
// Design: one thread per output element, e = u*D + c, walking its slot's
// run in order; for D = 32 a warp owns one slot and each of its loads of a
// cotangent row is one coalesced 128-byte segment.
//
// ---------------------------------------------------------------------------
// dfm_install: replaces `_install_kernel` (pallas_embedding.py, reached
// through `install_pallas`). One hot/cold cache transaction, IN PLACE in
// the hot tables: for every i < P with 0 <= slots[i] < H,
//
//   w[slots[i], :] = wv[i, :];  m[slots[i], :] = mv[i, :];
//   v[slots[i], :] = vv[i, :];  tau[slots[i]]  = tv[i]
//
// for w, m, v float32 [H, D] (D = 1 for the 1-D fm_w table), tau int32 [H],
// slots int32 [P] and the values [P, D] / [P]. Any other slot (the pow-2
// padding carries H) is dropped. The caller's in-bounds slots are distinct
// (free-list slots and distinct LRU victims), so the order of the stores
// cannot matter and the result equals four per-array scatters element for
// element. Values are copied as raw 32-bit words.
//
// Bound: bytes. One read of the slots (4P), one read of the I real value
// rows and one write of the I installed rows, each 3*4*D + 4 bytes:
// 4P + 2 I (12 D + 4). At D = 32, I ~ 10k, P = 16,384: ~7.8 MB, 2.3 us at
// 3.35 TB/s; at D = 1 a few hundred KB, so the launch sets the time.
//
// Design: the Pallas body is a serial loop over the slots that first copies
// each whole table into a fresh output. Here the tables are written where
// they lie, one thread per (slot, column), e = i*D + c, grid-stride: each
// thread reads its slot, skips it when out of range, and copies one word of
// w, m and v; column 0 also copies tau. For D = 32 a warp moves one
// contiguous 128-byte row segment of each array.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // elementwise and scan blocks
constexpr int kItems = 8;                  // scan elements per thread
constexpr int kTile = kThreads * kItems;   // scan elements per block
constexpr int kSumThreads = 1024;          // the one block over tile totals
constexpr int64_t kMaxBlocks = 1 << 20;    // grid-stride beyond this

__device__ __forceinline__ int64_t plan_id(int32_t id, int64_t rows) {
  return (id < 0 || static_cast<int64_t>(id) > rows) ? rows
                                                     : static_cast<int64_t>(id);
}

// Exclusive scan of one int per thread across the block (blockDim.x a
// multiple of 32, every thread present). Returns this thread's prefix and
// stores the block total in *total. Ends with a barrier, so it may be
// called again at once.
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_off[32];
  __shared__ int block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_off[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < nwarps ? warp_off[lane] : 0;
    int sinc = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, sinc, off);
      if (lane >= off) sinc += y;
    }
    warp_off[lane] = sinc - s;
    if (lane == 31) block_total = sinc;
  }
  __syncthreads();
  const int out = inc - x + warp_off[warp];
  *total = block_total;
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
plan_mark(const int32_t* __restrict__ ids, int64_t n, int64_t rows,
          int32_t* __restrict__ marks, int32_t* __restrict__ uids) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    marks[plan_id(ids[i], rows)] = 1;
    uids[i] = static_cast<int32_t>(rows);
  }
}

__global__ void __launch_bounds__(kThreads)
plan_scan_tiles(int32_t* __restrict__ rank, int64_t len, int64_t rows,
                uint8_t* __restrict__ touched, int32_t* __restrict__ tiles) {
  const int64_t base =
      blockIdx.x * static_cast<int64_t>(kTile) + threadIdx.x * kItems;
  int v[kItems];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = base + j;
    const int m = r < len ? rank[r] : 0;
    if (r < rows) touched[r] = static_cast<uint8_t>(m != 0);
    v[j] = m;
    sum += m;
  }
  int total;
  int run = block_exclusive_scan(sum, &total);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = base + j;
    if (r < len) rank[r] = run;
    run += v[j];
  }
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kSumThreads)
plan_scan_sums(int32_t* __restrict__ tiles, int64_t n_tiles) {
  int carry = 0;
  for (int64_t base = 0; base < n_tiles; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const int x = i < n_tiles ? tiles[i] : 0;
    int total;
    const int ex = block_exclusive_scan(x, &total);
    if (i < n_tiles) tiles[i] = carry + ex;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
plan_add_emit(int32_t* __restrict__ rank, int64_t len, int64_t rows,
              const uint8_t* __restrict__ touched,
              const int32_t* __restrict__ tiles, int32_t* __restrict__ uids) {
  for (int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       r < len; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int v = rank[r] + tiles[r / kTile];
    rank[r] = v;
    if (r < rows && touched[r]) uids[v] = static_cast<int32_t>(r);
  }
}

__global__ void __launch_bounds__(kThreads)
plan_remap(const int32_t* __restrict__ ids, int64_t n, int64_t rows,
           const int32_t* __restrict__ rank, int32_t* __restrict__ inv) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    inv[i] = rank[plan_id(ids[i], rows)];
  }
}

template <typename T>  // raw bits: uint32_t (float32) or uint16_t (bfloat16)
__global__ void __launch_bounds__(kThreads)
take_fwd_kernel(const T* __restrict__ rows, const int32_t* __restrict__ inv,
                T* __restrict__ out, int64_t n, int64_t u, int64_t d) {
  const int64_t total = n * d;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = e / d;
    const int64_t c = e - p * d;
    const int64_t s = inv[p];
    out[e] = (s >= 0 && s < u) ? rows[s * d + c] : T(0);
  }
}

__device__ __forceinline__ float add_in(float acc, float x) { return acc + x; }
__device__ __forceinline__ __nv_bfloat16 add_in(__nv_bfloat16 acc,
                                                __nv_bfloat16 x) {
  return __float2bfloat16(__bfloat162float(acc) + __bfloat162float(x));
}

template <typename T>  // float or __nv_bfloat16
__global__ void __launch_bounds__(kThreads)
take_bwd_kernel(const T* __restrict__ g, const int32_t* __restrict__ order,
                const int32_t* __restrict__ starts, T* __restrict__ out,
                int64_t u, int64_t d) {
  const int64_t total = u * d;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t slot = e / d;
    const int64_t c = e - slot * d;
    T acc = static_cast<T>(0.0f);
    int j = starts[slot];
    const int end = starts[slot + 1];
    // Four loads in flight, then four adds in order: the sum order stays
    // ascending p while a long run does not wait on one load at a time.
    for (; j + 4 <= end; j += 4) {
      const T x0 = g[static_cast<int64_t>(order[j]) * d + c];
      const T x1 = g[static_cast<int64_t>(order[j + 1]) * d + c];
      const T x2 = g[static_cast<int64_t>(order[j + 2]) * d + c];
      const T x3 = g[static_cast<int64_t>(order[j + 3]) * d + c];
      acc = add_in(add_in(add_in(add_in(acc, x0), x1), x2), x3);
    }
    for (; j < end; ++j) {
      acc = add_in(acc, g[static_cast<int64_t>(order[j]) * d + c]);
    }
    out[e] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
install_kernel(uint32_t* __restrict__ w, uint32_t* __restrict__ m,
               uint32_t* __restrict__ v, int32_t* __restrict__ tau,
               const int32_t* __restrict__ slots,
               const uint32_t* __restrict__ wv, const uint32_t* __restrict__ mv,
               const uint32_t* __restrict__ vv, const int32_t* __restrict__ tv,
               int64_t h, int64_t p, int64_t d) {
  const int64_t total = p * d;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = e / d;
    const int64_t c = e - i * d;
    const int64_t s = slots[i];
    if (s < 0 || s >= h) continue;
    const int64_t dst = s * d + c;
    w[dst] = wv[e];
    m[dst] = mv[e];
    v[dst] = vv[e];
    if (c == 0) tau[s] = tv[i];
  }
}

unsigned blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

int64_t tiles_for(int64_t rows) { return (rows + 1 + kTile - 1) / kTile; }

}  // namespace

// Tile totals the plan build needs as scratch (int32 elements) for a table
// of `rows` rows; the caller allocates them.
extern "C" int64_t dfm_plan_tiles(int64_t rows) { return tiles_for(rows); }

// ids int32 [n] -> uids, inv int32 [n], touched bool [rows], rank int32
// [rows+1]; tiles int32 [dfm_plan_tiles(rows)] scratch. Returns the first
// cudaError_t of its launches (0 on success); the caller raises otherwise.
extern "C" int dfm_plan_build(const void* ids, void* uids, void* inv,
                              void* touched, void* rank, void* tiles,
                              int64_t n, int64_t rows, void* stream) {
  if (n < 0 || rows < 1 || rows >= INT32_MAX || n >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t len = rows + 1;
  const int64_t n_tiles = tiles_for(rows);
  const int32_t* id = static_cast<const int32_t*>(ids);
  int32_t* rk = static_cast<int32_t*>(rank);
  int32_t* ti = static_cast<int32_t*>(tiles);
  uint8_t* tch = static_cast<uint8_t*>(touched);
  cudaError_t err = cudaMemsetAsync(rk, 0, len * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    plan_mark<<<blocks_for(n), kThreads, 0, s>>>(
        id, n, rows, rk, static_cast<int32_t*>(uids));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  plan_scan_tiles<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      rk, len, rows, tch, ti);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  plan_scan_sums<<<1, kSumThreads, 0, s>>>(ti, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  plan_add_emit<<<blocks_for(len), kThreads, 0, s>>>(
      rk, len, rows, tch, ti, static_cast<int32_t*>(uids));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    plan_remap<<<blocks_for(n), kThreads, 0, s>>>(
        id, n, rows, rk, static_cast<int32_t*>(inv));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// rows [u, d] of `dtype` (0 = float32, 1 = bfloat16), inv int32 [n] ->
// out [n, d]. Same error return as the plan build.
extern "C" int dfm_take_fwd(const void* rows, const void* inv, void* out,
                            int64_t n, int64_t u, int64_t d, int dtype,
                            void* stream) {
  if (n <= 0 || u < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n * d);
  const int32_t* iv = static_cast<const int32_t*>(inv);
  switch (dtype) {
    case 0:
      take_fwd_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
          static_cast<const uint32_t*>(rows), iv, static_cast<uint32_t*>(out),
          n, u, d);
      break;
    case 1:
      take_fwd_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(rows), iv, static_cast<uint16_t*>(out),
          n, u, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g [n, d] of `dtype`, order int32 [n], starts int32 [u+1] -> out [u, d].
// Same error return as the plan build.
extern "C" int dfm_take_bwd(const void* g, const void* order,
                            const void* starts, void* out, int64_t u,
                            int64_t d, int dtype, void* stream) {
  if (u <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(u * d);
  const int32_t* ord = static_cast<const int32_t*>(order);
  const int32_t* st = static_cast<const int32_t*>(starts);
  switch (dtype) {
    case 0:
      take_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(g), ord, st, static_cast<float*>(out), u,
          d);
      break;
    case 1:
      take_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(g), ord, st,
          static_cast<__nv_bfloat16*>(out), u, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// w, m, v float32 [h, d], tau int32 [h], slots int32 [p], wv, mv, vv
// float32 [p, d], tv int32 [p]: the transaction above, in place. Same error
// return as the plan build; p = 0 launches nothing.
extern "C" int dfm_install(void* w, void* m, void* v, void* tau,
                           const void* slots, const void* wv, const void* mv,
                           const void* vv, const void* tv, int64_t h,
                           int64_t p, int64_t d, void* stream) {
  if (h <= 0 || p < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  install_kernel<<<blocks_for(p * d), kThreads, 0, s>>>(
      static_cast<uint32_t*>(w), static_cast<uint32_t*>(m),
      static_cast<uint32_t*>(v), static_cast<int32_t*>(tau),
      static_cast<const int32_t*>(slots), static_cast<const uint32_t*>(wv),
      static_cast<const uint32_t*>(mv), static_cast<const uint32_t*>(vv),
      static_cast<const int32_t*>(tv), h, p, d);
  return static_cast<int>(cudaGetLastError());
}
