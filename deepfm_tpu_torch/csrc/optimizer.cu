// Sparse exact Adagrad for Hopper (sm_90a): the row update of the sparse
// step's per-feature tables (DLRM-DCNv2's `--optimizer exact_adagrad
// --embedding_update sparse`).
//
// ---------------------------------------------------------------------------
// dfm_sparse_adagrad: replaces no TPU kernel. The JAX package has no DLRM
// and no sparse Adagrad (its sparse update is lazy Adam), so there is no
// Pallas kernel to port; this one takes the place of the plain path
// `sparse_adagrad_apply_tables` (train/optimizers.py) on the card. For up
// to 32 tables in one launch. Table t: the gradient rows g [N_t, K], the
// plan's uids [N_t] (int32: the distinct touched rows, then the fill id
// rows_t), and the table and its accumulator [rows_t, K], all float32. For
// every slot s with r = uids[s] < rows_t, and each of the K elements, each
// operation rounded on its own (no FMA contraction):
//
//   g2 = g * g;  a = acc[r] + g2;  den = sqrt(a) + eps;  du = (g / den) * -lr
//   acc[r] = a;  table[r] = table[r] + du
//
// which is the plain path's arithmetic in its order: its foreach ops round
// each operation, and its index_add_ adds du and g2 at the row once (lr
// and eps as float32, as the foreach ops convert them). A fill slot (r >=
// rows_t) is skipped before anything else of it is read: its gradient is
// zero, and the plain path's add of that zero at its spread row changes no
// bit. So the result is the plain path's bit for bit.
//
// No races: the plan deduplicates, so the real slots of a table name
// distinct rows, and fill slots write nothing. Every row is read and
// written by one warp: plain loads and stores, no atomics.
//
// Bound: device-memory bytes. A touched row reads its gradient, its
// accumulator and its value and writes the last two: 5 x 4K bytes, 2,560
// at K = 128 (plus 4 bytes of uid a slot). At the DLRM-DCNv2 cell's step
// (B = 16,384, 26 tables, ~2.70 M touched rows of 3.51 M slots) ~6.9 GB,
// ~2.1 ms at 3.35 TB/s. Five floating-point operations an element: far
// below the card's operation rate.
//
// What it replaces: the plain path over every slot, fill slots included:
// an index_select of the accumulator rows, six foreach passes and two
// index_add_ a table, ~40 GB a step (19 ms of the cell's 37 ms step on an
// H100 80GB HBM3 at 700 W).
//
// Design: one warp per slot row, a lane per 16-byte chunk of it (one float4
// each of g, accumulator and value at K = 128: three coalesced 512-byte
// reads a row), or per element where K is not a multiple of 4 or a row is
// not 16-byte aligned (the scalar path; 1-D tables are K = 1). A warp takes
// kSlots consecutive slots of one table: lane i < kSlots reads uid s0 + i,
// a shuffle hands them round, and the warp issues the loads of all its live
// rows before it uses any, so that enough random rows are in flight to keep
// device memory busy. The tables' slot groups lie end to end (a prefix of
// their counts in the argument struct); the grid is one wave of resident
// blocks walking the groups with a grid stride, so a warp's table index
// only grows and it finds it by stepping forward. The plan's uids ascend,
// so the rows a wave touches at once lie close together.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxTables = 32;   // tables one launch serves
constexpr int kThreads = 256;
constexpr int kSlots = 4;        // slot rows a warp has in flight
constexpr int kMaxDevices = 64;

struct AdagradTable {
  const void* g;         // [n, k]
  const int32_t* uids;   // [n]
  void* table;           // [rows, k]
  void* acc;             // [rows, k]
  int64_t n;
  int64_t rows;
};

struct AdagradArgs {
  AdagradTable tab[kMaxTables];
  int64_t group_end[kMaxTables];  // inclusive prefix of ceil(n_t / kSlots)
  int tables;
  int chunks;                     // chunks a row (K / 4, or K)
  float neg_lr;
  float eps;
};

__device__ __forceinline__ float step(float g, float& a, float v, float neg_lr,
                                      float eps) {
  a = __fadd_rn(a, __fmul_rn(g, g));
  const float den = __fadd_rn(__fsqrt_rn(a), eps);
  return __fadd_rn(v, __fmul_rn(__fdiv_rn(g, den), neg_lr));
}

__device__ __forceinline__ float step(float g, float& a, float v,
                                      const AdagradArgs& p) {
  return step(g, a, v, p.neg_lr, p.eps);
}

__device__ __forceinline__ float4 step(float4 g, float4& a, float4 v,
                                       const AdagradArgs& p) {
  return make_float4(step(g.x, a.x, v.x, p.neg_lr, p.eps),
                     step(g.y, a.y, v.y, p.neg_lr, p.eps),
                     step(g.z, a.z, v.z, p.neg_lr, p.eps),
                     step(g.w, a.w, v.w, p.neg_lr, p.eps));
}

// C: the chunk a lane moves (float4, or float on the scalar path).
template <typename C>
__global__ void __launch_bounds__(kThreads)
sparse_adagrad_kernel(const __grid_constant__ AdagradArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t total = a.group_end[a.tables - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t chunks = a.chunks;
  int t = 0;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                   (threadIdx.x >> 5);
       w < total; w += stride) {
    while (w >= a.group_end[t]) ++t;  // the same for the whole warp
    const AdagradTable& tb = a.tab[t];
    const int64_t s0 = (w - (t > 0 ? a.group_end[t - 1] : 0)) * kSlots;
    int32_t mine = -1;
    if (lane < kSlots && s0 + lane < tb.n) mine = __ldg(tb.uids + s0 + lane);
    int64_t row[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int32_t r = __shfl_sync(0xffffffffu, mine, j);
      row[j] = r >= 0 && r < tb.rows ? r : -1;  // -1: past the end or fill
    }
    const C* g = static_cast<const C*>(tb.g);
    C* acc = static_cast<C*>(tb.acc);
    C* val = static_cast<C*>(tb.table);
    for (int64_t c = lane; c < chunks; c += 32) {
      C gx[kSlots], ax[kSlots], vx[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (row[j] >= 0) {
          gx[j] = __ldcs(g + (s0 + j) * chunks + c);
          ax[j] = acc[row[j] * chunks + c];
          vx[j] = val[row[j] * chunks + c];
        }
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (row[j] >= 0) {
          vx[j] = step(gx[j], ax[j], vx[j], a);
          acc[row[j] * chunks + c] = ax[j];
          val[row[j] * chunks + c] = vx[j];
        }
      }
    }
  }
}

std::atomic<int> g_sm_count[kMaxDevices];

// One wave of resident blocks (`per_sm`: the kernel's occupancy, read
// once), or fewer where the groups need fewer.
template <typename K>
cudaError_t wave_blocks(K kernel, int64_t need, std::atomic<int>& per_sm,
                        unsigned* blocks) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = g_sm_count[dev].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sm_count[dev].store(sms);
  }
  int occ = per_sm.load();
  if (occ == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    occ = occ < 1 ? 1 : occ;
    per_sm.store(occ);
  }
  const int64_t wave = static_cast<int64_t>(occ) * sms;
  if (need > wave) need = wave;
  *blocks = static_cast<unsigned>(need < 1 ? 1 : need);
  return cudaSuccess;
}

template <typename C>
cudaError_t launch(const AdagradArgs& a, cudaStream_t s) {
  static std::atomic<int> per_sm{0};
  const int warps = kThreads / 32;
  unsigned blocks;
  cudaError_t err =
      wave_blocks(sparse_adagrad_kernel<C>,
                  (a.group_end[a.tables - 1] + warps - 1) / warps, per_sm,
                  &blocks);
  if (err != cudaSuccess) return err;
  sparse_adagrad_kernel<C><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ptrs: host array of 4 t device pointers, table i's at [4i, 4i + 4): g
// (float32 [n[i], k]), uids (int32 [n[i]]), table and accumulator (float32
// [rows[i], k]); 1 <= t <= 32. The update above for every table, in place,
// one launch on `stream`. Returns 0 or a cudaError_t (cudaErrorInvalidValue
// for arguments out of range); no slots launch nothing.
extern "C" int dfm_sparse_adagrad(const void* const* ptrs, const int64_t* n,
                                  const int64_t* rows, int t, int64_t k,
                                  float lr, float eps, void* stream) {
  if (t < 1 || t > kMaxTables || k <= 0 || k >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AdagradArgs a = {};
  int64_t groups = 0;
  uintptr_t addr = 0;
  for (int i = 0; i < t; ++i) {
    if (n[i] < 0 || n[i] >= INT32_MAX || rows[i] <= 0 ||
        rows[i] >= INT32_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const void* const* q = ptrs + 4 * i;
    AdagradTable& tb = a.tab[i];
    tb.g = q[0];
    tb.uids = static_cast<const int32_t*>(q[1]);
    tb.table = const_cast<void*>(q[2]);
    tb.acc = const_cast<void*>(q[3]);
    tb.n = n[i];
    tb.rows = rows[i];
    addr |= reinterpret_cast<uintptr_t>(q[0]) |
            reinterpret_cast<uintptr_t>(q[2]) |
            reinterpret_cast<uintptr_t>(q[3]);
    groups += (n[i] + kSlots - 1) / kSlots;
    a.group_end[i] = groups;
  }
  if (groups == 0) return 0;
  a.tables = t;
  a.neg_lr = -lr;
  a.eps = eps;
  const bool vec = k % 4 == 0 && addr % 16 == 0;
  a.chunks = static_cast<int>(vec ? k / 4 : k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch<float4>(a, s) : launch<float>(a, s));
}
