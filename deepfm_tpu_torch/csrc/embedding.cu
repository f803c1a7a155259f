// Sparse embedding plane for Hopper (sm_90a): the plan build, the gather
// forward with its position-order segment-sum backward, and the hot/cold
// tier's cache install.
//
// ---------------------------------------------------------------------------
// dfm_plan_build: replaces the TPU kernel deepfm_tpu/ops/pallas_embedding.py
// `_plan_kernel` (:121, its pallas_call at :173), for up to 8 tables in one
// launch. For table t, ids int32 [N] (row t of ids [T, N]) with values in
// [0, rows_t] (the value rows_t is the fill id of masked positions):
//
//   touched[r] = r occurs in ids                      (r < rows_t)
//   rank[r]    = number of distinct ids below r       (r < rows_t)
//   uids[j]    = the j-th distinct id, ascending; rows_t past the last one
//   inv[i]     = number of distinct ids below ids[i]
//
// which is jnp.unique(ids, size=N, fill_value=rows_t, return_inverse=True)
// bit for bit: a fill position's inv is the number of real uniques, and a
// present fill id lands in uids at that slot. An id outside [0, rows_t] is
// read as the fill id (inv = the number of real uniques), so no id ever
// writes outside a buffer; the JAX package's callers never produce one
// (hash buckets are < rows, masked positions carry rows). uids and inv are
// [T, N]; the tables' touched and rank lie end to end, table t at offset
// rows_0 + ... + rows_{t-1}.
//
// Bound: device-memory bytes. Each input and output once: ids, uids, inv
// (4N bytes each), touched (rows bytes) and rank (4 rows bytes) a table. At
// the hashed training step (4 tables, N = 39,936, rows = 262,144) that is
// 7.16 MB, 2.14 us at 3.35 TB/s (0.53 us a table). A dozen integer
// operations per id: far below the card's operation rate.
//
// What held the previous design back: a memset and five dependent kernels a
// table (mark, tile scan, one block over the tile sums, add and emit,
// remap), the marks and ranks round-tripping through a [rows+1] int32 array
// in device memory, launched once per table: 24 device events and ~0.052 ms
// per hashed step for ~2 us of traffic. Launch latency and the chain of
// dependent passes, not bytes, set its time.
//
// Design: one launch of thread-block clusters of 8 CTAs (portable size).
// The id space [0, rows] is a bitmap in a cluster's distributed shared
// memory: CTA c owns words [c*W, (c+1)*W), W = ceil((rows/32 + 1)/8)
// (1,025 words at 262,144 rows; 7,813 at 2,000,000, which takes dynamic
// shared memory above 48 KB), plus one int prefix per word. Each table gets
// as many clusters ("parts") as fit on the card at once beside the other
// tables' (cudaOccupancyMaxActiveClusters / T); every part builds the
// table's bitmap, and part p writes only its share of the outputs, so the
// [rows]-sized writes, which one cluster's 8 SMs issue too slowly, spread
// over the card. Nothing but the inputs and outputs touches device memory:
//   1. each CTA zeroes its slice; cluster barrier, its latency overlapping
//      the loads of the CTA's N/8 ids into registers;
//   2. each CTA ORs each id's bit into the owning CTA's slice with a remote
//      atomic (the fill id, 3/4 of a hashed table's positions, is flagged in
//      shared memory and sent once per CTA); cluster barrier;
//   3. each CTA scans its words' popcounts into per-word prefixes and
//      publishes its total; cluster barrier, overlapping the part's touched
//      writes; every CTA reads the 8 totals over DSMEM: its own base, every
//      owner's base and the real uniques;
//   4. inv[i] = the owner's base and word prefix plus the popcount of the
//      lower bits: two DSMEM loads per id (a fill id needs none), for the
//      part's share of the CTA's positions (ids still in registers);
//   5. one warp per word writes rank of its 32 rows (lane l writes row
//      32w+l: one 128-byte line per store) and uids[rank] = r for set bits;
//      the parts' CTAs split the fill tail uids[n_real, N), so each uids
//      slot is written exactly once and nothing pre-fills it;
//   6. a last cluster barrier (relaxed, arrived at before step 5), so no
//      CTA exits while its slice is read.
// No memset, no scratch, no second launch. What remains sets the time: each
// cluster barrier and DSMEM round trip costs a fraction of a microsecond,
// and step 2's remote atomics serialise at the owners (chip_smoke's
// plan_floor line times the launch with almost no work).
//
// ---------------------------------------------------------------------------
// dfm_take_fwd: replaces `_take_fwd_kernel` (pallas_embedding.py:216, its
// pallas_call at :240), fused with the hashed layout's mask and table sum,
// for up to 8 tables in one launch:
//
//   out[p, :] = (rows_0[inv_0[p], :] * mask_0[p]
//                + rows_1[inv_1[p], :] * mask_1[p]) + ...   (table order)
//
// for rows_t [U_t, D] (separate tensors, passed as a pointer array), inv_t
// int32 [N] and optional float32 masks [N]; an inv outside [0, U_t) reads
// zeros. Each product and sum is one IEEE float32 operation in this order
// (__fmul_rn / __fadd_rn, no FMA contraction): the operations of torch's
// composition `take * mask + take * mask + ...`, so the result equals it
// bit for bit. Without masks the products are left out; one table without
// masks is rows[inv], copied as raw bits (float32 or bfloat16). Masks or
// several tables take float32 rows.
//
// Bound: bytes, each input and output once: T*4N (inv) + T*4N (masks) +
// sum_t 4D*(referenced rows_t + 1) + 4DN (out). At the hashed step (T = 4,
// N = 39,936, D = 32, ~9,631 referenced rows a table) that is ~11.3 MB,
// 3.38 us at 3.35 TB/s; one table without masks, 6.5 MB, 1.94 us.
//
// What held the previous design back: one thread per 4-byte element with
// two 64-bit divides each, every element waiting on a dependent inv load
// and then a row load, over ~5 waves of blocks (0.78 TB/s at D = 32). Around
// it each embedding name took 4 takes into separate [N, D] tensors, 4 mask
// products and 3 adds: 11 launches and ~8 [N, D] round trips through device
// memory per name.
//
// Design: each thread moves 16 bytes at a time (8 threads cover a 128-byte
// float32 row at D = 32; 8-, 4- or 2-byte chunks when the rows are narrower
// or unaligned, so D = 1 is a scalar path of the same structure). A thread
// owns one chunk column of several positions: it loads all their inv and
// mask values first, then issues every table's row loads for all of them,
// then computes and streams the outputs (st.global.cs), so 4-8 independent
// row loads are in flight per thread. Index math is 32-bit with no divides;
// the grid is one wave of resident blocks and strides beyond it. The row
// load is not skipped where a mask is 0: that row is the plan's fill slot,
// the zero row every masked position reads, one line that stays in cache.
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
#include <cooperative_groups.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // elementwise blocks
constexpr int64_t kMaxBlocks = 1 << 20;    // grid-stride beyond this
constexpr int kMaxTables = 8;              // tables a plan or take launch serves
constexpr int kCluster = 8;                // CTAs per table in the plan build
constexpr int kPlanThreads = 1024;
constexpr int kPlanIds = 8;                // ids per thread in flight
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int plan_id(int32_t id, int rows) {
  return (id < 0 || id > rows) ? rows : id;
}

// Bitmap words each CTA of a table's cluster owns: the id space [0, rows]
// is rows/32 + 1 words.
__host__ __device__ __forceinline__ int plan_words_per_cta(int rows) {
  return ((rows >> 5) + 1 + kCluster - 1) / kCluster;
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

struct PlanArgs {
  const int32_t* ids;  // [T, n]
  int32_t* uids;       // [T, n]
  int32_t* inv;        // [T, n]
  uint8_t* touched;    // the tables' [rows_t] end to end
  int32_t* rank;       // the tables' [rows_t] end to end
  int n;
  int parts;           // clusters per table, each writing its part
  int rows[kMaxTables];
  int64_t off[kMaxTables];
};

// The two halves of a cluster barrier, so that independent work runs
// between them: arrive (release: this thread's earlier shared-memory
// writes are visible after the wait), or arrive relaxed (orders nothing;
// for the last barrier, which only keeps the slices alive), then wait
// (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// This thread's ids of the chunk of positions at b (position b + j *
// blockDim.x + threadIdx.x in slot j); -1 past hi.
__device__ __forceinline__ void plan_load(int (&id)[kPlanIds],
                                          const int32_t* ids, int b, int hi,
                                          int rows) {
#pragma unroll
  for (int j = 0; j < kPlanIds; ++j) {
    const int i = b + j * static_cast<int>(blockDim.x) +
                  static_cast<int>(threadIdx.x);
    id[j] = i < hi ? plan_id(__ldg(ids + i), rows) : -1;
  }
}

// Grid T * parts * kCluster, cluster dimension kCluster: the clusters
// q = t * parts + p, p < parts, all build table t's bitmap, and cluster p
// writes part p of the outputs (the steps of the header note). Dynamic
// shared memory: the bitmap slice and its per-word prefixes,
// 2 * plan_words_per_cta(max rows) words.
__global__ void __launch_bounds__(kPlanThreads) plan_kernel(PlanArgs a) {
  extern __shared__ uint32_t smem[];
  __shared__ int saw_fill;
  __shared__ int cta_total;
  __shared__ int base_of[kCluster];
  __shared__ int n_real_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / kCluster;
  const int t = q / a.parts;
  const int part = q - t * a.parts;
  const int rows = a.rows[t];
  const int n = a.n;
  const int wpc = plan_words_per_cta(rows);
  uint32_t* bits = smem;
  int* pre = reinterpret_cast<int*>(smem + wpc);
  const int32_t* ids = a.ids + static_cast<int64_t>(t) * n;
  int32_t* uids = a.uids + static_cast<int64_t>(t) * n;
  int32_t* inv = a.inv + static_cast<int64_t>(t) * n;
  uint8_t* touched = a.touched + a.off[t];
  int32_t* rank = a.rank + a.off[t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int fill_word = rows >> 5;
  const int fill_owner = fill_word / wpc;
  // This CTA marks positions [lo, hi); this cluster's part of the rows is
  // the slice's words [wlo, whi).
  const int share = (n + kCluster - 1) / kCluster;
  const int lo = min(n, me * share);
  const int hi = min(n, lo + share);
  const int span = blockDim.x * kPlanIds;
  const int sub = (wpc + a.parts - 1) / a.parts;
  const int wlo = min(wpc, part * sub);
  const int whi = min(wpc, wlo + sub);
  const int first_row = me * wpc * 32;

  // 1. Zero this CTA's slice; the id loads overlap the barrier.
  for (int w = threadIdx.x; w < wpc; w += blockDim.x) bits[w] = 0u;
  if (threadIdx.x == 0) saw_fill = 0;
  cluster_arrive();
  int id[kPlanIds];
  plan_load(id, ids, lo, hi, rows);
  cluster_wait();

  // 2. Mark the ids in the owners' slices; the fill id once per CTA.
  for (int b = lo;;) {
#pragma unroll
    for (int j = 0; j < kPlanIds; ++j) {
      const int x = id[j];
      if (x == rows) {
        saw_fill = 1;
      } else if (x >= 0) {
        const int w = x >> 5;
        const int owner = w / wpc;
        atomicOr(cluster.map_shared_rank(bits, owner) + (w - owner * wpc),
                 1u << (x & 31));
      }
    }
    b += span;
    if (b >= hi) break;
    plan_load(id, ids, b, hi, rows);
  }
  __syncthreads();
  if (threadIdx.x == 0 && saw_fill) {
    atomicOr(cluster.map_shared_rank(bits, fill_owner) +
                 (fill_word - fill_owner * wpc),
             1u << (rows & 31));
  }
  cluster.sync();

  // 3. Per-word prefixes of this slice; its total goes to the cluster,
  // and the touched marks of this part's rows overlap the barrier.
  const int per = (wpc + blockDim.x - 1) / blockDim.x;
  const int w0 = threadIdx.x * per;
  int sum = 0;
  for (int k = 0; k < per; ++k) {
    if (w0 + k < wpc) sum += __popc(bits[w0 + k]);
  }
  int total;
  int run = block_exclusive_scan(sum, &total);
  for (int k = 0; k < per; ++k) {
    if (w0 + k < wpc) {
      pre[w0 + k] = run;
      run += __popc(bits[w0 + k]);
    }
  }
  if (threadIdx.x == 0) cta_total = total;
  cluster_arrive();
  for (int w = wlo + warp; w < whi; w += nwarps) {
    const int r = first_row + w * 32 + lane;
    if (r < rows) touched[r] = (bits[w] >> lane) & 1u;
  }
  cluster_wait();
  if (warp == 0) {
    const int v = lane < kCluster ? *cluster.map_shared_rank(&cta_total, lane)
                                  : 0;
    int inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += y;
    }
    if (lane < kCluster) base_of[lane] = inc - v;
    const int all = __shfl_sync(0xffffffffu, inc, 31);
    if (lane == 0) {
      const uint32_t fw = *(cluster.map_shared_rank(bits, fill_owner) +
                            (fill_word - fill_owner * wpc));
      n_real_s = all - static_cast<int>((fw >> (rows & 31)) & 1u);
    }
  }
  __syncthreads();
  const int base = base_of[me];
  const int n_real = n_real_s;

  // 4. inv: slot j of this CTA's positions belongs to part j % parts (the
  // ids of a single chunk are still in registers).
  const bool single = hi - lo <= span;
  for (int b = lo; b < hi; b += span) {
    if (!single) plan_load(id, ids, b, hi, rows);
#pragma unroll
    for (int j = 0; j < kPlanIds; ++j) {
      const int i = b + j * static_cast<int>(blockDim.x) +
                    static_cast<int>(threadIdx.x);
      if (j % a.parts != part || i >= hi) continue;
      int v = n_real;
      if (id[j] != rows) {
        const int w = id[j] >> 5;
        const int owner = w / wpc;
        const int lw = w - owner * wpc;
        const uint32_t word = cluster.map_shared_rank(bits, owner)[lw];
        v = base_of[owner] + cluster.map_shared_rank(pre, owner)[lw] +
            __popc(word & ((1u << (id[j] & 31)) - 1u));
      }
      inv[i] = v;
    }
  }
  // No other CTA's slice is read past this point.
  cluster_arrive_relaxed();

  // 5. rank of this part's rows and uids of their set bits; this part's
  // share of the fill tail.
  for (int w = wlo + warp; w < whi; w += nwarps) {
    const uint32_t word = bits[w];
    const int r = first_row + w * 32 + lane;
    if (r < rows) {
      const int rk = base + pre[w] + __popc(word & ((1u << lane) - 1u));
      rank[r] = rk;
      if ((word >> lane) & 1u) uids[rk] = r;
    }
  }
  const int tail = n - n_real;
  const int pieces = a.parts * kCluster;
  const int tshare = (tail + pieces - 1) / pieces;
  const int tlo = n_real + min(tail, (part * kCluster + me) * tshare);
  const int thi = min(n, tlo + tshare);
  for (int j = tlo + static_cast<int>(threadIdx.x); j < thi; j += blockDim.x) {
    uids[j] = rows;
  }

  // 6. Keep this slice alive until every CTA of the cluster is done with it.
  cluster_wait();
}

struct TakeArgs {
  const void* rows[kMaxTables];
  const int32_t* inv[kMaxTables];
  const float* mask[kMaxTables];  // all null without masks
  int u[kMaxTables];
  void* out;
  int n;
  int tables;
  int chunks;  // chunks of the kernel's chunk type per row
};

__device__ __forceinline__ float mul_rn(float x, float m) {
  return __fmul_rn(x, m);
}
__device__ __forceinline__ float2 mul_rn(float2 x, float m) {
  return make_float2(__fmul_rn(x.x, m), __fmul_rn(x.y, m));
}
__device__ __forceinline__ float4 mul_rn(float4 x, float m) {
  return make_float4(__fmul_rn(x.x, m), __fmul_rn(x.y, m),
                     __fmul_rn(x.z, m), __fmul_rn(x.w, m));
}
__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ float2 add_rn(float2 x, float2 y) {
  return make_float2(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y));
}
__device__ __forceinline__ float4 add_rn(float4 x, float4 y) {
  return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                     __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
}

// C: the chunk a thread moves (float4, float2, float: float32 lanes; or
// unsigned short, a raw bfloat16, one table and no masks only). kT: tables
// the registers hold (>= a.tables); kP: positions per thread. Block
// (x, y): x walks a row's chunks, y the positions.
template <typename C, int kT, int kP>
__global__ void __launch_bounds__(kThreads) take_fwd_kernel(TakeArgs a) {
  constexpr bool kMath = !std::is_same<C, unsigned short>::value;
  const bool masked = a.mask[0] != nullptr;
  const int by = blockDim.y;
  const int group = by * kP;
  C* out = static_cast<C*>(a.out);
  for (int base = blockIdx.x * group; base < a.n; base += gridDim.x * group) {
    int slot[kT][kP];
    float m[kT][kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int p = base + j * by + threadIdx.y;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        slot[t][j] = -1;
        m[t][j] = 1.0f;
        if (t < a.tables && p < a.n) {
          slot[t][j] = __ldg(a.inv[t] + p);
          if (masked) m[t][j] = __ldg(a.mask[t] + p);
        }
      }
    }
    for (int c = threadIdx.x; c < a.chunks; c += blockDim.x) {
      C r[kT][kP];
#pragma unroll
      for (int j = 0; j < kP; ++j) {
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const int s = slot[t][j];
          r[t][j] = C{};
          if (s >= 0 && s < a.u[t]) {
            r[t][j] = __ldg(static_cast<const C*>(a.rows[t]) +
                            static_cast<int64_t>(s) * a.chunks + c);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        const int p = base + j * by + threadIdx.y;
        if (p >= a.n) continue;
        C acc = r[0][j];
        if constexpr (kMath) {
          if (masked) acc = mul_rn(acc, m[0][j]);
#pragma unroll
          for (int t = 1; t < kT; ++t) {
            if (t < a.tables) {
              acc = add_rn(acc, masked ? mul_rn(r[t][j], m[t][j]) : r[t][j]);
            }
          }
        }
        __stcs(out + static_cast<int64_t>(p) * a.chunks + c, acc);
      }
    }
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


// Per-device facts the launches need, read once; and, for the plan build,
// the dynamic shared memory set on the kernel and how many of its clusters
// fit on the card at that size.
std::atomic<int> g_sm_count[kMaxDevices];
std::atomic<int> g_smem_optin[kMaxDevices];
std::atomic<int> g_plan_smem_set[kMaxDevices];
std::atomic<int> g_plan_clusters_smem[kMaxDevices];
std::atomic<int> g_plan_clusters[kMaxDevices];

cudaError_t device_facts(int* dev, int* sms, int* smem_optin) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int s = g_sm_count[*dev].load();
  int o = g_smem_optin[*dev].load();
  if (s == 0 || o == 0) {
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 *dev);
    if (err != cudaSuccess) return err;
    g_sm_count[*dev].store(s);
    g_smem_optin[*dev].store(o);
  }
  *sms = s;
  *smem_optin = o;
  return cudaSuccess;
}

dim3 take_block(int chunks) {
  const int bx = chunks < kThreads ? chunks : kThreads;
  return dim3(bx, kThreads / bx);
}

// One wave of resident blocks, or fewer when the positions need fewer.
template <typename C, int kT, int kP>
cudaError_t launch_take(const TakeArgs& a, cudaStream_t s) {
  static std::atomic<int> per_sm{0};
  int dev, sms, optin;
  cudaError_t err = device_facts(&dev, &sms, &optin);
  if (err != cudaSuccess) return err;
  int occ = per_sm.load();
  if (occ == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, take_fwd_kernel<C, kT, kP>, kThreads, 0);
    if (err != cudaSuccess) return err;
    occ = occ < 1 ? 1 : occ;
    per_sm.store(occ);
  }
  const dim3 block = take_block(a.chunks);
  const int64_t group = static_cast<int64_t>(block.y) * kP;
  int64_t blocks = (a.n + group - 1) / group;
  const int64_t wave = static_cast<int64_t>(occ) * sms;
  if (blocks > wave) blocks = wave;
  take_fwd_kernel<C, kT, kP>
      <<<static_cast<unsigned>(blocks < 1 ? 1 : blocks), block, 0, s>>>(a);
  return cudaGetLastError();
}

// Registers for the next power of two of tables; fewer positions per
// thread as the tables grow, so 4-8 row chunks are in flight per thread.
template <typename C>
cudaError_t take_tables(const TakeArgs& a, cudaStream_t s) {
  if (a.tables == 1) return launch_take<C, 1, 4>(a, s);
  if (a.tables == 2) return launch_take<C, 2, 4>(a, s);
  if (a.tables <= 4) return launch_take<C, 4, 2>(a, s);
  return launch_take<C, 8, 1>(a, s);
}

}  // namespace

// ids int32 [t, n] -> uids, inv int32 [t, n]; touched bool and rank int32
// of the t tables end to end (table i: rows[i] entries at offset rows[0] +
// ... + rows[i-1]); rows: host int64 [t], 1 <= t <= 8. One cluster launch.
// Returns the launch's cudaError_t (0 on success), also when the cluster
// launch is refused; the caller raises otherwise.
extern "C" int dfm_plan_build(const void* ids, void* uids, void* inv,
                              void* touched, void* rank, const int64_t* rows,
                              int t, int64_t n, void* stream) {
  if (t < 1 || t > kMaxTables || n < 0 || n >= INT32_MAX || rows == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlanArgs a = {};
  a.ids = static_cast<const int32_t*>(ids);
  a.uids = static_cast<int32_t*>(uids);
  a.inv = static_cast<int32_t*>(inv);
  a.touched = static_cast<uint8_t*>(touched);
  a.rank = static_cast<int32_t*>(rank);
  a.n = static_cast<int>(n);
  int64_t off = 0;
  int wpc = 1;
  for (int i = 0; i < t; ++i) {
    if (rows[i] < 1 || rows[i] > INT32_MAX - 64) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.rows[i] = static_cast<int>(rows[i]);
    a.off[i] = off;
    off += rows[i];
    const int w = plan_words_per_cta(a.rows[i]);
    wpc = w > wpc ? w : wpc;
  }
  const int smem = 2 * wpc * static_cast<int>(sizeof(uint32_t));
  int dev, sms, optin;
  cudaError_t err = device_facts(&dev, &sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Static shared memory (the scan's and the cluster's words) stays below 1 KB.
  if (smem + 1024 > optin) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kPlanThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > g_plan_smem_set[dev].load()) {
    err = cudaFuncSetAttribute(plan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_plan_smem_set[dev].store(smem);
  }
  if (smem != g_plan_clusters_smem[dev].load()) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, plan_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_plan_clusters[dev].store(clusters);
    g_plan_clusters_smem[dev].store(smem);
  }
  // As many clusters per table as fit on the card at once: each builds the
  // table's bitmap and writes its part of the outputs.
  a.parts = g_plan_clusters[dev].load() / t;
  a.parts = a.parts < 1 ? 1 : a.parts;
  cfg.gridDim = dim3(static_cast<unsigned>(t * a.parts * kCluster));
  err = cudaLaunchKernelEx(&cfg, plan_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// rows: host array of t device pointers to [u[i], d] of `dtype` (0 =
// float32, 1 = bfloat16); inv: t pointers to int32 [n]; masks: null, or t
// pointers to float32 [n]; out [n, d]: the fused take above, one launch,
// 1 <= t <= 8. bfloat16 rows take one table and no masks. Same error
// return as the plan build.
extern "C" int dfm_take_fwd(const void* const* rows, const void* const* inv,
                            const void* const* masks, const int64_t* u, int t,
                            void* out, int64_t n, int64_t d, int dtype,
                            void* stream) {
  if (t < 1 || t > kMaxTables || n <= 0 || n >= INT32_MAX || d <= 0 ||
      (dtype != 0 && dtype != 1) ||
      (dtype == 1 && (t > 1 || masks != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t item = dtype == 0 ? 4 : 2;
  const int64_t row_bytes = d * item;
  TakeArgs a = {};
  uintptr_t addr = reinterpret_cast<uintptr_t>(out);
  for (int i = 0; i < t; ++i) {
    if (u[i] < 0 || u[i] >= INT32_MAX ||
        (masks != nullptr && masks[i] == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.rows[i] = rows[i];
    a.inv[i] = static_cast<const int32_t*>(inv[i]);
    a.mask[i] = masks == nullptr ? nullptr
                                 : static_cast<const float*>(masks[i]);
    a.u[i] = static_cast<int>(u[i]);
    addr |= reinterpret_cast<uintptr_t>(rows[i]);
  }
  // The widest chunk that divides a row and every base address.
  int64_t chunk = 16;
  while (chunk > item && (row_bytes % chunk != 0 || addr % chunk != 0)) {
    chunk >>= 1;
  }
  if (row_bytes / chunk >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.out = out;
  a.n = static_cast<int>(n);
  a.tables = t;
  a.chunks = static_cast<int>(row_bytes / chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16: return static_cast<int>(take_tables<float4>(a, s));
    case 8: return static_cast<int>(take_tables<float2>(a, s));
    case 4: return static_cast<int>(take_tables<float>(a, s));
    default: return static_cast<int>(launch_take<unsigned short, 1, 4>(a, s));
  }
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
