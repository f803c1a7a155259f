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
// dfm_take_bwd: replaces `_take_bwd_kernel` (pallas_embedding.py:226), for
// up to 8 tables that share one cotangent g [N, D] in one launch. For
// table t:
//
//   d_rows_t[u, :] = sum over the positions p with inv_t[p] = u of g[p, :]
//
// SUMMED IN ASCENDING p STARTING FROM 0.0f: the order of the Pallas loop
// and of XLA's scatter-add, so the result equals the JAX package's gradient
// bit for bit. bfloat16 cotangents round the running sum to bfloat16 after
// each add, as the Pallas kernel's `out += g` in g's dtype does. Every add
// is one __fadd_rn; no tree sum, no reduction across lanes, no float
// atomics (their order changes from run to run).
//
// Input layout per table: the positions grouped by slot, ascending within
// a slot, as order int32 [N] and starts int32 [U_t+1] (slot u owns
// order[starts[u] .. starts[u+1])). The caller builds every table's with
// one stable sort (integer bookkeeping, shared by every embedding name),
// and may leave out positions whose cotangent is always zero (a hashed
// table's masked positions, all in its fill slot): adding +0.0 to a sum
// that starts from +0.0 changes no bit. Slots with no position (most of a
// hashed table's, which has as many slots as positions) are written as
// zeros.
//
// Bound: bytes, each input and output once: the kept positions' cotangent
// rows (each position is kept in one table of the hashed layout), order
// and starts, and sum_t 4 U_t D output bytes. At the hashed step (T = 4,
// N = U = 39,936, D = 32) ~26 MB, 7.9 us at 3.35 TB/s, 78% of it the
// output; at D = 1 under 1 MB, so the launch and the chain of dependent
// loads (starts -> order -> g) set the time.
//
// What held the previous design back: one thread per output element, with
// a 64-bit divide each, every thread re-reading its slot's starts and
// order entries (D times per slot), and one launch per (table, name): 8 a
// hashed step, 4 x 0.0058 ms at D = 32 and 4 x 0.0020 at D = 1 (H100 80GB
// HBM3, 700 W).
//
// Design: one launch over every table; a warp takes 32 consecutive slots
// of one table (tables' warps are laid end to end; the warp finds its
// table by reading the argument struct at constant indices only), and
// lane l reads slot s0 + l's starts[s] and starts[s+1] once.
//   - D = 1 (a row of one chunk): one lane per slot, the warp's 32 slots at
//     once, four cotangents in flight along a run, plain stores (streaming
//     stores of 4 bytes a lane were slower on an H100). At D = 1 the
//     launch is all latency; the kernel below for wider rows would cost it
//     registers and instructions it does not use.
//   - Wider rows: a slot's row is summed by a group of G lanes, G the power
//     of two >= the row's 16-, 8- or 4-byte chunks (8 lanes of float4 at
//     D = 32, so a warp takes 4 slots a round and 8 rounds). Up to eight
//     rounds start together: their runs come from the lanes' registers by
//     shuffle, one lane of each group reads the run's first position and
//     passes it on, and every lane loads that row's chunk, so the chain of
//     dependent loads (starts -> order -> g) is paid once for 32 slots,
//     not once a round. A longer run continues in order: the group reads
//     its order entries G at a time, one per lane, and each lane keeps four
//     cotangent chunks in flight before it adds them.
// The wider rows' empty slots are streamed out as zeros (st.global.cs). The
// grid is one wave of resident blocks.
//
// What held that design back on long runs: a run is walked by one group of
// lanes (one lane at D = 1), a handful of positions per memory round trip.
// In DeepFM's Criteo step (B = 131,072, F = 39, 117,632 rows), the 13
// integer fields are one id each at every row: 13 runs of 131,072
// positions a table. The fm_v launch (D = 32) took 104.7 ms a step and
// the fm_w launch (D = 1) 10.2 ms, ~0.8 us a position at D = 32, while 13
// groups of 8 lanes were the only work on 132 SMs (H100 80GB HBM3, 700 W):
// memory latency, not the adds, set the time. The ascending-p order itself
// needs one chain of dependent adds per column, 131,072 long: ~4 cycles an
// add, ~0.3 ms.
//
// The long-run path: a run of more than kLongRun positions is left by the
// kernels above, which mark it in long_mask (one 32-bit word a warp, bit l
// for its slot s0 + l; every word is written on every launch, so nothing
// is cleared first), and summed by take_bwd_long_kernel, launched next on
// the same stream. Every CTA of that launch reads the mask and numbers the
// long runs in the same order; a CTA takes one 32-byte slice of one run's
// rows (a sector: a D = 32 float32 run gives 4 CTAs, so each SM's read
// rate stays well under its share of L2 and memory). Four producer warps
// fill a ring of kLongStages stages of kLongStage positions in shared
// memory: each reads a stage's order entries (those of its next two turns
// in flight) and issues one cp.async per row chunk, which arrive on the
// stage's mbarrier as they land (2-byte bfloat16 units, a size cp.async
// lacks, go through registers). One consumer warp adds each stage from
// shared memory in ascending p from 0.0, lane e owning element e of the
// slice: one chain of add_rn a lane, each lane kLongBatch positions of
// loads ahead of its adds, across stage boundaries, then frees the stage.
// So the sum waits on its chain of adds, with ~2,000 positions of rows in
// flight, not on a round trip per handful. No atomics, no split of a
// column's chain, the same adds and bfloat16 rounding as the walk above:
// the same bits. At the Criteo step's shape the fm_v launch takes 0.68 ms
// (0.45 of it the long kernel) and the fm_w launch 0.51 ms (0.47), against
// the chain's ~0.3 ms floor; a lane holding a float4 chunk, four chains,
// took 0.72 ms in its long kernel (H100 80GB HBM3, 700 W). A launch
// without long runs pays the second launch, whose CTAs read the mask, find
// nothing and exit: ~3 us of device time at the hashed step.
// kLongRun is from a sweep on that card (summed over a D = 32 and a D = 1
// launch): runs of 128 positions cost less in the walk above, which
// overlaps the short runs, and runs of 256 and more less here; the
// lengths between were not measured, so runs of up to 256 stay on the walk.
//
// ---------------------------------------------------------------------------
// dfm_install: replaces `_install_kernel` (pallas_embedding.py:302, reached
// through `install_pallas`), for up to 8 tables that share one slots
// array in one launch. One hot/cold cache transaction, IN PLACE in the hot
// tables: for every table t and every i < P with 0 <= slots[i] < H,
//
//   w_t[slots[i], :] = wv_t[i, :];  m_t[slots[i], :] = mv_t[i, :];
//   v_t[slots[i], :] = vv_t[i, :];  tau_t[slots[i]]  = tv_t[i]
//
// for w, m, v float32 [H, D_t] (D_t = 1 for the 1-D fm_w table), tau int32
// [H], slots int32 [P] and the values [P, D_t] / [P]. Any other slot (the
// pow-2 padding carries H) is dropped. The caller's in-bounds slots are
// distinct (free-list slots and distinct LRU victims), so the order of the
// stores cannot matter and the result equals four per-array scatters per
// table element for element. Values are copied as raw 32-bit words.
//
// Bound: bytes. One read of the slots (4P), and per table one read of the
// I real value rows and one write of the I installed rows, each
// 3*4*D_t + 4 bytes: 4P + sum_t 2 I (12 D_t + 4). At D = 32 and 1, I ~
// 10k, P = 16,384: ~8.2 MB, 2.45 us at 3.35 TB/s.
//
// What held the previous design back: one thread per (slot, column) with a
// 64-bit divide each, the slot read D times, and one launch per table: the
// D = 1 launch (fm_w) moved a few hundred KB at 5% of its bound.
//
// Design: a warp takes one table's rows of 32 consecutive transactions
// (the tables' warps of one block of transactions are neighbours, so they
// share its slots line); lane l reads slots[i0 + l] once. A row is copied
// by a group of G lanes (G the power of two >= its 16-, 8- or 4-byte
// chunks: 8 lanes at D = 32, one at D = 1), and each lane issues the w, m
// and v value loads of up to eight rows before the slots arrive (the
// values' addresses do not depend on them), so only the stores wait: one
// memory latency per warp, not a chain of them. Lane l copies its own
// slot's tau. No divides; the tables' pointers ride in the launch's
// argument struct, read at constant indices.
//
// ---------------------------------------------------------------------------
// dfm_segments: the position order of `_take_bwd_kernel`
// (pallas_embedding.py:226), whose loop adds out[inv[p]] += g[p] for p
// ascending. dfm_take_bwd sums over a position CSR instead; this kernel
// builds it, for up to 8 tables in one launch. For table t, inv [N]
// (int32 or int64, row t of inv [T, N]), its slot count U_t and an
// optional keep [N] (bool):
//
//   key[p]    = inv[p] if keep[p] and 0 <= inv[p] < U_t, else U_t
//   order_t   = the positions sorted by key, ascending p within a key
//   starts_t  = [U_t + 1]: where key u's run starts; starts_t[U_t] is the
//               count of positions whose key is below U_t
//
// which is unique: the stable sort by key and a searchsorted of its bounds,
// bit for bit (the plain version, embedding_kernels.py
// `reference_position_segments`). order is [T, N]; the tables' starts lie
// end to end, table t at offset (U_0 + 1) + ... + (U_{t-1} + 1).
//
// Bound: bytes, each input and output once: inv (4 or 8 N bytes a table),
// keep (N), order (4N) and starts (4 (U_t + 1)). At the hashed step (T = 4,
// N = U = 39,936, keep) ~2.08 MB, 0.62 us at 3.35 TB/s; over the
// vocabulary (T = 1, N = 39,936 int64 ids, U = 117,632) ~0.95 MB, 0.28 us.
// A few integer operations per byte: far below the operation rate. Each
// of the five phases below measured 2-8 us on an H100 80GB HBM3 at 700 W
// (a grid-wide barrier and one or two dependent memory round trips), 0.019
// to 0.045 ms a call in all: latency, not bytes, sets the time.
//
// What it replaces: a stable radix sort (torch.sort) over a composite key
// plus a searchsorted: ~20-23 device events and 0.06-0.07 ms a call on an
// H100 80GB HBM3 at 700 W, more than the take backward that reads it.
//
// Design: one cooperative launch (one resident block per SM, grid-wide
// barriers), five phases; every loop over positions walks the T * N
// positions of all tables at once, one a thread a pass (the keep and inv
// loads do not wait for each other; batching four positions a thread, so
// that fewer warps held more loads, measured slower on an H100):
//   1. zero the counts (starts doubles as the count array; no memset, no
//      scratch carried between calls);
//   2. count each key with integer atomics (exact in any order), one
//      atomic per group of equal keys in a warp (__match_any_sync); the
//      left-out key U_t, most of a hashed table's positions, is counted in
//      shared memory and added once per block;
//   3. a scan of the counts over every table's slots end to end (block
//      sums, then each block's carry), leaving each run's END; runs of 2 to
//      kSegSmall, of up to kSegLong and of more positions are listed (a
//      long run's entry becomes its START, as -1 - start);
//   4. every position of a run that is not long takes place --end of its
//      key (one atomicSub per group of equal keys in a warp), so each run
//      holds its positions in some order and starts ends at the runs'
//      starts; meanwhile blocks count each long run's positions in chunks
//      of 512 or more positions;
//   5. order restored within each listed run: a thread sorts a run of up to
//      kSegSmall positions in registers (most runs hold 1-3 and need
//      nothing), a block sorts a run of up to kSegLong in shared memory
//      (bitonic), and a long run (a Zipf-hot slot, the left-out tail of a
//      hashed table) is written by stable compaction, each chunk from its
//      count's prefix and a block scan of its flags, in parallel over
//      chunks.
// Integer work only, so the result is the same on every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // take blocks
constexpr int kMaxTables = 8;              // tables one launch serves
constexpr int kCluster = 8;                // CTAs per table in the plan build
constexpr int kPlanThreads = 1024;
constexpr int kPlanIds = 8;                // ids per thread in flight
constexpr int kMaxDevices = 64;
constexpr int kSegThreads = 512;           // segments blocks
constexpr int kSegSmall = 16;              // runs a thread sorts itself
constexpr int kSegLong = 1024;             // runs a block sorts in shared memory
constexpr int kSegMaxBlocks = 1024;
constexpr int64_t kSegMaxPositions = 1 << 30;  // T * N, int32 loops
constexpr int kSegBlocksPerSm = 1;         // at most, of the resident ones
constexpr int kLongRun = 256;              // longer runs: the long-run path
constexpr int kLongSlice = 32;             // bytes of a row one long CTA sums
constexpr int kLongStage = 128;            // positions a ring stage holds
constexpr int kLongStages = 16;            // stages in a long CTA's ring
constexpr int kLongProducers = 4;          // warps that fill the ring
constexpr int kLongThreads = 32 * (1 + kLongProducers);
constexpr int kLongWords = 32;             // mask words a thread reads a pass
constexpr int kLongRing = kLongStages * kLongStage * kLongSlice;  // bytes

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

__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 acc,
                                                __nv_bfloat16 x) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(acc), __bfloat162float(x)));
}

template <typename C>
__device__ __forceinline__ C zero_chunk() {
  return C{};
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_chunk<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

template <typename C>
__device__ __forceinline__ void store_cs(C* p, C x) {
  __stcs(p, x);
}
template <>
__device__ __forceinline__ void store_cs<__nv_bfloat16>(__nv_bfloat16* p,
                                                        __nv_bfloat16 x) {
  *p = x;
}

// Lanes of a group of `g` (a power of two <= 32) that holds `lane`.
__device__ __forceinline__ unsigned group_mask(int g, int lane) {
  return g == 32 ? 0xffffffffu : ((1u << g) - 1u) << (lane & ~(g - 1));
}

struct TakeBwdArgs {
  const void* g;                      // [n, chunks] of the chunk type
  const int32_t* order[kMaxTables];   // [n]
  const int32_t* starts[kMaxTables];  // [u_t + 1]
  void* out[kMaxTables];              // [u_t, chunks]
  uint32_t* long_mask;  // [warps]: bit l of word w set where warp w's slot
                        // s0 + l holds more than kLongRun positions
  long long* stats;     // null, or {long runs, their positions} of a launch
  int u[kMaxTables];
  int warp_end[kMaxTables];  // inclusive prefix of ceil(u_t / 32)
  int warps;   // warp_end of the last table
  int tables;
  int chunks;  // chunks of the kernel's chunk type per row
  int group;   // lanes per slot: the power of two >= chunks, at most 32
  int lchunks;  // units of the long-run kernel's unit type per row
};

constexpr int kBwdBatch = 8;  // slots a group starts at once

// The rest of a run after its first position: the group reads its order
// entries once, gs at a time (one per lane), and passes each position
// around; every lane loads four cotangent chunks before it adds them, in
// order, to `acc`.
template <typename C>
__device__ __forceinline__ C take_bwd_walk(C acc, const C* g,
                                           const int32_t* order, int j,
                                           int end, int gs, int lg,
                                           unsigned gmask, int chunks, int c,
                                           bool active) {
  for (; j < end; j += gs) {
    const int m = min(gs, end - j);
    const int mine = lg < m ? __ldg(order + j + lg) : 0;
    int i = 0;
    for (; i + 4 <= m; i += 4) {
      const int p0 = __shfl_sync(gmask, mine, i, gs);
      const int p1 = __shfl_sync(gmask, mine, i + 1, gs);
      const int p2 = __shfl_sync(gmask, mine, i + 2, gs);
      const int p3 = __shfl_sync(gmask, mine, i + 3, gs);
      if (active) {
        const C x0 = __ldg(g + static_cast<int64_t>(p0) * chunks + c);
        const C x1 = __ldg(g + static_cast<int64_t>(p1) * chunks + c);
        const C x2 = __ldg(g + static_cast<int64_t>(p2) * chunks + c);
        const C x3 = __ldg(g + static_cast<int64_t>(p3) * chunks + c);
        acc = add_rn(add_rn(add_rn(add_rn(acc, x0), x1), x2), x3);
      }
    }
    for (; i < m; ++i) {
      const int p = __shfl_sync(gmask, mine, i, gs);
      if (active) {
        acc = add_rn(acc, __ldg(g + static_cast<int64_t>(p) * chunks + c));
      }
    }
  }
  return acc;
}

// Warp w's table among a launch's, read from the argument struct at
// constant indices only (a dynamic index would load from memory).
struct BwdTable {
  const int32_t* order;
  const int32_t* starts;
  void* out;
  int u;
  int first_warp;
};

__device__ __forceinline__ BwdTable bwd_table(const TakeBwdArgs& a, int w) {
  BwdTable b = {a.order[0], a.starts[0], a.out[0], a.u[0], 0};
#pragma unroll
  for (int t = 1; t < kMaxTables; ++t) {
    if (t < a.tables && w >= a.warp_end[t - 1]) {
      b = {a.order[t], a.starts[t], a.out[t], a.u[t], a.warp_end[t - 1]};
    }
  }
  return b;
}

// Rows of one chunk (D = 1): one lane per slot, so a warp's 32 slots go at
// once, and a run is walked with four cotangents in flight.
template <typename C>
__global__ void __launch_bounds__(kThreads)
take_bwd_lane_kernel(const __grid_constant__ TakeBwdArgs a) {
  const C* g = static_cast<const C*>(a.g);
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * (blockDim.x >> 5);
  for (int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       w < a.warps; w += stride) {
    const BwdTable b = bwd_table(a, w);
    const int s = (w - b.first_warp) * 32 + lane;
    int j = 0, end = 0;
    if (s < b.u) {
      j = __ldg(b.starts + s);
      end = __ldg(b.starts + s + 1);
    }
    // A long run is marked for take_bwd_long_kernel and left to it.
    const bool lng = end - j > kLongRun;
    const unsigned longs = __ballot_sync(0xffffffffu, lng);
    if (lane == 0) a.long_mask[w] = longs;
    if (s >= b.u || lng) continue;
    C acc = zero_chunk<C>();
    for (; j + 4 <= end; j += 4) {
      const C x0 = __ldg(g + __ldg(b.order + j));
      const C x1 = __ldg(g + __ldg(b.order + j + 1));
      const C x2 = __ldg(g + __ldg(b.order + j + 2));
      const C x3 = __ldg(g + __ldg(b.order + j + 3));
      acc = add_rn(add_rn(add_rn(add_rn(acc, x0), x1), x2), x3);
    }
    for (; j < end; ++j) acc = add_rn(acc, __ldg(g + __ldg(b.order + j)));
    static_cast<C*>(b.out)[s] = acc;
  }
}

// Rows of several chunks, a group of a.group lanes per slot. C: the chunk
// a lane moves (float4, float2, float: float32 lanes; or one
// __nv_bfloat16). Warp w of the grid-stride loop takes the 32 slots
// [s0, s0 + 32) of one table (the steps of the header note).
template <typename C>
__global__ void __launch_bounds__(kThreads)
take_bwd_kernel(const __grid_constant__ TakeBwdArgs a) {
  const C* g = static_cast<const C*>(a.g);
  const int lane = threadIdx.x & 31;
  const int gs = a.group;
  const int per_round = 32 / gs;  // slots a warp walks at once
  const int k = lane / gs;        // this lane's group
  const int lg = lane - k * gs;   // its lane in the group
  const unsigned gmask = group_mask(gs, lane);
  const int chunks = a.chunks;
  const int stride = gridDim.x * (blockDim.x >> 5);
  for (int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       w < a.warps; w += stride) {
    const BwdTable b = bwd_table(a, w);
    const int u = b.u;
    const int32_t* starts = b.starts;
    const int32_t* order = b.order;
    C* out = static_cast<C*>(b.out);
    const int s0 = (w - b.first_warp) * 32;
    int lo = 0, hi = 0;
    if (s0 + lane < u) {
      lo = __ldg(starts + s0 + lane);
      hi = __ldg(starts + s0 + lane + 1);
    }
    // Long runs are marked for take_bwd_long_kernel and left to it.
    const unsigned longs = __ballot_sync(0xffffffffu, hi - lo > kLongRun);
    if (lane == 0) a.long_mask[w] = longs;
    for (int c0 = 0; c0 < chunks; c0 += gs) {  // one pass while D fits
      const int c = c0 + lg;
      const bool active = c < chunks;
      for (int r0 = 0; r0 < gs; r0 += kBwdBatch) {
        // Up to eight rounds at once: their runs from registers, then the
        // first position of every non-empty run (one lane of the group
        // reads it), then its cotangent chunk, all loads in flight.
        int beg[kBwdBatch], end[kBwdBatch], head[kBwdBatch];
        C x[kBwdBatch];
#pragma unroll
        for (int r = 0; r < kBwdBatch; ++r) {
          const int src = ((r0 + r) * per_round + k) & 31;
          beg[r] = __shfl_sync(0xffffffffu, lo, src);
          end[r] = __shfl_sync(0xffffffffu, hi, src);
          if (r0 + r >= gs || s0 + src >= u || ((longs >> src) & 1u)) {
            end[r] = -1;  // no such slot, or a long run
          }
          head[r] = 0;
          if (lg == 0 && beg[r] < end[r]) head[r] = __ldg(order + beg[r]);
        }
#pragma unroll
        for (int r = 0; r < kBwdBatch; ++r) {
          x[r] = zero_chunk<C>();
          if (beg[r] < end[r]) {  // the same for every lane of the group
            const int p = __shfl_sync(gmask, head[r], 0, gs);
            if (active) x[r] = __ldg(g + static_cast<int64_t>(p) * chunks + c);
          }
        }
#pragma unroll
        for (int r = 0; r < kBwdBatch; ++r) {
          if (end[r] < 0) continue;
          const int src = (r0 + r) * per_round + k;
          // 0.0 + the first row (0.0 + 0.0 for an empty slot), then the
          // rest of the run: the adds of a walk from 0.0 in ascending p.
          C acc = add_rn(zero_chunk<C>(), x[r]);
          acc = take_bwd_walk(acc, g, order, beg[r] + 1, end[r], gs, lg,
                              gmask, chunks, c, active);
          if (active) {
            store_cs(out + static_cast<int64_t>(s0 + src) * chunks + c, acc);
          }
        }
      }
    }
  }
}

// The long-run path's pipeline and barriers (the header note): mbarriers in
// shared memory, and cp.async copies that arrive on one when they land.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}
// Arrives once every cp.async this thread issued before has landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// One unit from device memory into shared memory, in flight until an
// mbar_arrive_copies: cp.async of 4, 8 or 16 bytes.
template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8 || sizeof(V) == 16, "");
  if constexpr (sizeof(V) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(static_cast<int>(sizeof(V)))
                 : "memory");
  }
}

__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 acc,
                                                 __nv_bfloat162 x) {
  return __halves2bfloat162(add_rn(__low2bfloat16(acc), __low2bfloat16(x)),
                            add_rn(__high2bfloat16(acc), __high2bfloat16(x)));
}
template <>
__device__ __forceinline__ __nv_bfloat162 zero_chunk<__nv_bfloat162>() {
  return __float2bfloat162_rn(0.0f);
}

// The x-th set bit of m (x < popcount(m)).
__device__ __forceinline__ int nth_bit(uint32_t m, int x) {
  for (int i = 0; i < x; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

constexpr int kLongBatch = 16;  // positions a consumer lane has loaded ahead

// The element a consumer lane sums: float, or bfloat16 for the bfloat16
// units.
template <typename V>
using LongElem = typename std::conditional<
    std::is_same<V, __nv_bfloat16>::value ||
        std::is_same<V, __nv_bfloat162>::value,
    __nv_bfloat16, float>::type;

// Units [z * kUnits, + kUnits) of the rows of one long run, the slot of
// lane `bit` of mask warp w. Warps 1..kLongProducers fill the ring, a stage
// a turn each, with the order entries of their next two turns in flight;
// in warp 0, lane e adds element e of the slice over the stages in
// ascending p (one chain of adds a lane: a lane holding a float4 would
// issue four adds a position), loading kLongBatch positions ahead of its
// adds, across stage boundaries. `seq` counts the stages this CTA ran
// before, so the barriers' phases carry on from one run to the next.
template <typename V>
__device__ __forceinline__ void take_bwd_long_run(
    const TakeBwdArgs& a, int w, int bit, int z, int& seq, V* ring,
    uint64_t* full, uint64_t* empty, int (*pos)[kLongStage]) {
  using E = LongElem<V>;
  constexpr int kUnits = kLongSlice / sizeof(V);     // a power of two
  constexpr int kElems = kLongSlice / sizeof(E);     // at most 32
  constexpr int kCopies = kLongStage * kUnits / 32;  // a lane's, a stage
  constexpr int kPer = kLongStage / 32;              // order entries, same
  static_assert(kElems <= 32, "a consumer lane per element of a slice");
  const BwdTable b = bwd_table(a, w);
  const int s = (w - b.first_warp) * 32 + bit;
  const int beg = __ldg(b.starts + s);
  const int end = __ldg(b.starts + s + 1);
  const int c0 = z * kUnits;
  const int cw = min(kUnits, a.lchunks - c0);
  const int stages = (end - beg + kLongStage - 1) / kLongStage;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    constexpr int kPerUnit = sizeof(V) / sizeof(E);
    const int elems = a.lchunks * kPerUnit;  // a row's
    const int ce = min(kElems, elems - z * kElems);
    // Lanes past the slice add a copy of its last element, store nothing.
    const int l = min(lane, ce - 1);
    const E* ring_e = reinterpret_cast<const E*>(ring);
    auto stage = [&](int st) {  // waits for stage st; its elements, lane l
      const int q = seq + st;
      mbar_wait(&full[q % kLongStages], (q / kLongStages) & 1);
      return ring_e + (q % kLongStages) * kLongStage * kElems + l;
    };
    auto release = [&](int st) {
      __syncwarp();
      mbar_arrive(&empty[(seq + st) % kLongStages]);
    };
    const int whole = (end - beg) / kLongStage;  // stages of kLongStage
    E acc = zero_chunk<E>();
    E x[kLongBatch];
    const E* src = whole > 0 ? stage(0) : nullptr;
#pragma unroll
    for (int j = 0; j < kLongBatch; ++j) {
      if (whole > 0) x[j] = src[j * kElems];
    }
    for (int st = 0; st < whole; ++st) {
#pragma unroll
      for (int i = 0; i < kLongStage; i += kLongBatch) {
        E y[kLongBatch];
        if (i + kLongBatch < kLongStage) {
#pragma unroll
          for (int j = 0; j < kLongBatch; ++j) {
            y[j] = src[(i + kLongBatch + j) * kElems];
          }
        } else if (st + 1 < whole) {  // the next stage's first batch
          const E* nsrc = stage(st + 1);
#pragma unroll
          for (int j = 0; j < kLongBatch; ++j) y[j] = nsrc[j * kElems];
        } else {
#pragma unroll
          for (int j = 0; j < kLongBatch; ++j) y[j] = x[j];
        }
#pragma unroll
        for (int j = 0; j < kLongBatch; ++j) acc = add_rn(acc, x[j]);
        if (i + kLongBatch >= kLongStage) {
          release(st);
          src = ring_e + ((seq + st + 1) % kLongStages) * kLongStage *
                             kElems + l;
        }
#pragma unroll
        for (int j = 0; j < kLongBatch; ++j) x[j] = y[j];
      }
    }
    const int rest = end - beg - whole * kLongStage;
    if (rest > 0) {  // a last, shorter stage
      const E* tail = stage(whole);
      for (int i = 0; i < rest; ++i) acc = add_rn(acc, tail[i * kElems]);
      release(whole);
    }
    if (lane < ce) {
      reinterpret_cast<E*>(b.out)[static_cast<int64_t>(s) * elems +
                                  z * kElems + lane] = acc;
    }
  } else {
    const int pw = warp - 1;
    const V* g = static_cast<const V*>(a.g);
    int sh = 0;
    while ((1 << sh) < cw) ++sh;
    const int cp = 1 << sh;
    auto load_order = [&](int st, int (&ord)[kPer]) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int j = beg + st * kLongStage + m * 32 + lane;
        ord[m] = st < stages && j < end ? __ldg(b.order + j) : 0;
      }
    };
    // One turn: stage st from the order entries in `ord`, which then
    // load those of stage st + 2 * kLongProducers.
    auto turn = [&](int st, int (&ord)[kPer]) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) pos[pw][m * 32 + lane] = ord[m];
      load_order(st + 2 * kLongProducers, ord);
      __syncwarp();
      const int q = seq + st;
      const int k = q % kLongStages;
      if (q >= kLongStages) mbar_wait(&empty[k], (q / kLongStages - 1) & 1);
      const int cnt = min(kLongStage, end - beg - st * kLongStage);
      V* dst = ring + k * kLongStage * kUnits;
      // Copy i of the stage is unit i & (cp - 1) of position i >> sh, cp
      // the power of two >= cw: the lanes of a narrow slice stay busy.
      if constexpr (sizeof(V) >= 4) {
#pragma unroll 4
        for (int m = 0; m < kCopies; ++m) {
          const int i = m * 32 + lane;
          if ((i >> sh) >= kLongStage) break;
          const int p = i >> sh;
          const int c = i & (cp - 1);
          if (p < cnt && c < cw) {
            copy_async(dst + p * kUnits + c,
                       g + static_cast<int64_t>(pos[pw][p]) * a.lchunks +
                           c0 + c);
          }
        }
        mbar_arrive_copies(&full[k]);
      } else {  // 2-byte units, a size cp.async lacks: through registers,
                // 16 loads a lane in flight
        for (int m0 = 0; m0 < kCopies; m0 += 16) {
          V x[16];
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            const int i = (m0 + m) * 32 + lane;
            const int p = i >> sh;
            const int c = i & (cp - 1);
            if (p < cnt && c < cw) {
              x[m] = g[static_cast<int64_t>(pos[pw][p]) * a.lchunks + c0 +
                       c];
            }
          }
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            const int i = (m0 + m) * 32 + lane;
            const int p = i >> sh;
            const int c = i & (cp - 1);
            if (p < cnt && c < cw) dst[p * kUnits + c] = x[m];
          }
        }
        mbar_arrive(&full[k]);
      }
      __syncwarp();  // pos[pw] is written again next turn
    };
    int even[kPer], odd[kPer];
    load_order(pw, even);
    load_order(pw + kLongProducers, odd);
    for (int st = pw; st < stages; st += 2 * kLongProducers) {
      turn(st, even);
      if (st + kLongProducers < stages) turn(st + kLongProducers, odd);
    }
  }
  seq += stages;
}

// V: the unit a lane adds (float4, float2, float; __nv_bfloat162 or
// __nv_bfloat16). Grid: one wave of resident CTAs of kLongThreads. Every
// CTA reads the whole long_mask, kLongThreads * kLongWords words a pass,
// and numbers its set bits (the long runs) in the same order; item k =
// run * slices + slice goes to CTA k mod gridDim.x. CTA 0 writes `stats`
// where it is given.
template <typename V>
__global__ void __launch_bounds__(kLongThreads)
take_bwd_long_kernel(const __grid_constant__ TakeBwdArgs a) {
  constexpr int kUnits = kLongSlice / sizeof(V);
  extern __shared__ __align__(16) unsigned char long_ring[];
  __shared__ __align__(8) uint64_t full[kLongStages];
  __shared__ __align__(8) uint64_t empty[kLongStages];
  __shared__ int pos[kLongProducers][kLongStage];
  __shared__ int2 item;
  __shared__ unsigned long long positions;
  V* ring = reinterpret_cast<V*>(long_ring);
  const int tid = threadIdx.x;
  const bool count = a.stats != nullptr && blockIdx.x == 0;
  if (tid == 0) positions = 0;
  const int64_t slices = (a.lchunks + kUnits - 1) / kUnits;
  const int64_t grid = gridDim.x;
  const int64_t cta = blockIdx.x;
  int64_t base = 0;  // long runs of the passes before
  int seq = 0;
  bool ready = false;  // barriers initialised
  for (int w0 = 0; w0 < a.warps; w0 += kLongThreads * kLongWords) {
    uint32_t word[kLongWords];
    int mine = 0;
#pragma unroll
    for (int i = 0; i < kLongWords; ++i) {
      const int w = w0 + i * kLongThreads + tid;
      word[i] = w < a.warps ? a.long_mask[w] : 0u;
      mine += __popc(word[i]);
    }
    int total;
    const int before = block_exclusive_scan(mine, &total);
    if (count && mine > 0) {  // the words again, not unrolled
      long long n = 0;
#pragma unroll 1
      for (int i = 0; i < kLongWords; ++i) {
        const int w = w0 + i * kLongThreads + tid;
        for (uint32_t m = w < a.warps ? a.long_mask[w] : 0u; m != 0;
             m &= m - 1) {
          const BwdTable b = bwd_table(a, w);
          const int s = (w - b.first_warp) * 32 + __ffs(m) - 1;
          n += __ldg(b.starts + s + 1) - __ldg(b.starts + s);
        }
      }
      atomicAdd(&positions, static_cast<unsigned long long>(n));
    }
    const int64_t lo = base * slices;
    for (int64_t k = lo + ((cta - lo) % grid + grid) % grid;
         k < (base + total) * slices; k += grid) {
      const int r = static_cast<int>(k / slices - base);
      if (r >= before && r < before + mine) {  // this thread holds run r
        int x = r - before, w = 0, bit = 0;
#pragma unroll
        for (int i = 0; i < kLongWords; ++i) {
          const int c = __popc(word[i]);
          if (x >= 0 && x < c) {
            w = w0 + i * kLongThreads + tid;
            bit = nth_bit(word[i], x);
          }
          x -= c;
        }
        item = make_int2(w, bit);
      }
      if (!ready && tid < kLongStages) {
        mbar_init(&full[tid], 32);
        mbar_init(&empty[tid], 32);
      }
      ready = true;
      __syncthreads();
      const int2 it = item;
      take_bwd_long_run<V>(a, it.x, it.y, static_cast<int>(k % slices), seq,
                           ring, full, empty, pos);
      __syncthreads();  // `item` is written again
    }
    base += total;
  }
  if (count) {
    __syncthreads();
    if (tid == 0) {
      a.stats[0] = base;
      a.stats[1] = static_cast<long long>(positions);
      __threadfence_system();
    }
  }
}

struct InstallTable {
  uint32_t* w;          // [h, d] float32 as raw words
  uint32_t* m;
  uint32_t* v;
  int32_t* tau;         // [h]
  const uint32_t* wv;   // [p, d]
  const uint32_t* mv;
  const uint32_t* vv;
  const int32_t* tv;    // [p]
  int chunk;   // bytes a lane moves: 16, 8 or 4
  int chunks;  // chunks per row
  int group;   // lanes per slot: the power of two >= chunks, at most 32
};

struct InstallArgs {
  InstallTable tab[kMaxTables];
  const int32_t* slots;  // [p]
  int tables;
  int h;
  int p;
};

constexpr int kInstallThreads = 128;
constexpr int kInstallBatch = 8;  // slots whose copies a lane has in flight

// Table `tb`'s rows of the transactions [i0, i0 + 32): lane l reads
// slots[i0 + l]; every value load is issued before the slots arrive, and
// only the stores wait for them.
template <typename C, int kBatch>
__device__ __forceinline__ void install_rows_of(const InstallTable& tb,
                                                const int32_t* slots, int i0,
                                                int lane, int p, int h) {
  const int gs = tb.group;
  const int per_round = 32 / gs;
  const int k = lane / gs;
  const int lg = lane - k * gs;
  const int chunks = tb.chunks;
  const int mine = i0 + lane < p ? __ldg(slots + i0 + lane) : -1;
  const C* wv = reinterpret_cast<const C*>(tb.wv);
  const C* mv = reinterpret_cast<const C*>(tb.mv);
  const C* vv = reinterpret_cast<const C*>(tb.vv);
  C* w = reinterpret_cast<C*>(tb.w);
  C* m = reinterpret_cast<C*>(tb.m);
  C* v = reinterpret_cast<C*>(tb.v);
  for (int c0 = 0; c0 < chunks; c0 += gs) {  // one pass while D fits
    const int c = c0 + lg;
    for (int r0 = 0; r0 < gs; r0 += kBatch) {
      C x[kBatch][3];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int i = i0 + (r0 + r) * per_round + k;
        if (r0 + r < gs && i < p && c < chunks) {
          const int64_t from = static_cast<int64_t>(i) * chunks + c;
          x[r][0] = __ldg(wv + from);
          x[r][1] = __ldg(mv + from);
          x[r][2] = __ldg(vv + from);
        }
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        if (r0 + r < gs) {  // the same for the whole warp
          const int src = (r0 + r) * per_round + k;
          const int s = __shfl_sync(0xffffffffu, mine, src);
          if (i0 + src < p && s >= 0 && s < h && c < chunks) {
            const int64_t to = static_cast<int64_t>(s) * chunks + c;
            w[to] = x[r][0];
            m[to] = x[r][1];
            v[to] = x[r][2];
          }
        }
      }
    }
  }
  if (mine >= 0 && mine < h) tb.tau[mine] = __ldg(tb.tv + i0 + lane);
}

// Warp w of the grid-stride loop copies table t = w % tables of the 32
// transactions starting at (w / tables) * 32.
__global__ void __launch_bounds__(kInstallThreads)
install_kernel(const __grid_constant__ InstallArgs a) {
  const int lane = threadIdx.x & 31;
  const int warps = ((a.p + 31) / 32) * a.tables;
  const int stride = gridDim.x * (blockDim.x >> 5);
  for (int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       w < warps; w += stride) {
    const int t = w % a.tables;
    const int i0 = (w / a.tables) * 32;
    // The table's arguments, read at constant indices.
    InstallTable tb = a.tab[0];
#pragma unroll
    for (int tt = 1; tt < kMaxTables; ++tt) {
      if (tt == t) tb = a.tab[tt];
    }
    // One lane per row (a 1-D table) copies one row per round.
    if (tb.group == 1 && tb.chunk == 4) {
      install_rows_of<uint32_t, 1>(tb, a.slots, i0, lane, a.p, a.h);
      continue;
    }
    switch (tb.chunk) {
      case 16:
        install_rows_of<uint4, kInstallBatch>(tb, a.slots, i0, lane, a.p,
                                              a.h);
        break;
      case 8:
        install_rows_of<uint2, kInstallBatch>(tb, a.slots, i0, lane, a.p,
                                              a.h);
        break;
      default:
        install_rows_of<uint32_t, kInstallBatch>(tb, a.slots, i0, lane, a.p,
                                                 a.h);
        break;
    }
  }
}

struct SegArgs {
  const void* inv;       // [T, n], int32 or int64 (wide)
  const uint8_t* keep;   // [T, n] or null
  int32_t* order;        // [T, n]
  int32_t* starts;       // the tables' [u_t + 1] end to end, slots in all
  int* counters;         // runs listed: [0] short, [1] medium, [2] long
  int* block_sum;        // [gridDim.x]
  int4* shorts;          // {table, start, length, -}: 2..kSegSmall positions
  int4* medium;          // {table, start, length, -}: up to kSegLong
  int4* longs;           // {table, slot, start, length}: longer
  int* long_count;       // [long runs][chunks]: positions of each chunk
  int64_t off[kMaxTables];  // table t's starts begin at off[t]
  int64_t slots;
  int u[kMaxTables];
  int tables;
  int n;
  int wide;
  int chunk;             // positions of a long run's chunk
  int chunks;            // ceil(n / chunk)
};

// Table t's slot count and starts offset (the struct read at constant
// indices).
__device__ __forceinline__ void seg_table(const SegArgs& a, int t, int* u,
                                          int64_t* off) {
#pragma unroll
  for (int j = 0; j < kMaxTables; ++j) {
    if (j == t) {
      *u = a.u[j];
      *off = a.off[j];
    }
  }
}

// The table whose starts hold slot g of the array end to end.
__device__ __forceinline__ int seg_table_of(const SegArgs& a, int64_t g) {
  int t = 0;
#pragma unroll
  for (int j = 1; j < kMaxTables; ++j) {
    if (j < a.tables && g >= a.off[j]) t = j;
  }
  return t;
}

// The key of position p of the [T, n] inputs in a table of u slots: its
// inv, or u when it is left out or its inv lies outside [0, u). The keep
// and inv loads do not wait for each other.
__device__ __forceinline__ int seg_key(const SegArgs& a, int64_t p, int u) {
  const int kept = a.keep != nullptr ? a.keep[p] : 1;
  const long long v =
      a.wide ? __ldg(static_cast<const long long*>(a.inv) + p)
             : static_cast<long long>(
                   __ldg(static_cast<const int32_t*>(a.inv) + p));
  return (kept != 0 && v >= 0 && v < u) ? static_cast<int>(v) : u;
}

// A run's start from its starts entry: a long run's is stored as -1 -
// start until its compaction writes it back.
__device__ __forceinline__ int seg_start(int v) { return v >= 0 ? v : -1 - v; }

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// One cooperative launch of the five phases in the header note. Loops over
// positions walk whole warps over the T * n positions of every table (the
// collectives see all 32 lanes), and every block-wide loop is uniform
// across the block.
__global__ void __launch_bounds__(kSegThreads) segments_kernel(SegArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int run[kSegLong];
  __shared__ int tail[kMaxTables];
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  const int nthreads = static_cast<int>(gridDim.x * blockDim.x);
  const int gtid = static_cast<int>(blockIdx.x * blockDim.x) + tid;
  const int n = a.n;
  const int total = a.tables * n;
  const int64_t slots = a.slots;

  // 1. Zero the counts.
  for (int64_t g = gtid; g < slots; g += nthreads) a.starts[g] = 0;
  if (gtid < 3) a.counters[gtid] = 0;
  if (tid < kMaxTables) tail[tid] = 0;
  grid.sync();

  // 2. Count each key: one atomic per group of equal keys in a warp (the
  // keys are matched as slots of the array end to end); table t's left-out
  // key (matched as -2 - t) in shared memory, added once per block below.
  for (int b = gtid - lane; b < total; b += nthreads) {
    const int p = b + lane;
    int t = 0;
    long long g = -1;
    if (p < total) {
      t = p / n;
      int u;
      int64_t off;
      seg_table(a, t, &u, &off);
      const int key = seg_key(a, p, u);
      g = key == u ? -2 - t : off + key;
    }
    const unsigned peers =
        __match_any_sync(0xffffffffu, static_cast<unsigned long long>(g));
    if (g != -1 && lane == __ffs(peers) - 1) {
      if (g < 0) {
        atomicAdd(&tail[t], __popc(peers));
      } else {
        atomicAdd(&a.starts[g], __popc(peers));
      }
    }
  }
  __syncthreads();
  if (tid < a.tables && tail[tid] > 0) {
    int u;
    int64_t off;
    seg_table(a, tid, &u, &off);
    atomicAdd(&a.starts[off + u], tail[tid]);
  }
  grid.sync();

  // 3. Scan the counts over the slots end to end. Block b scans slots
  // [lo, hi), whole tiles of the block; its carry is the sum of the blocks
  // before it. Table t's positions precede slot off[t] t * n times over, so
  // a table-local place is the global prefix less t * n. Runs of 2 or more
  // positions are listed by length.
  const int64_t per =
      ((slots + gridDim.x - 1) / gridDim.x + blockDim.x - 1) / blockDim.x *
      blockDim.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t hi = lo + per < slots ? lo + per : slots;
  {
    int mine = 0;
    for (int64_t g = lo + tid; g < hi; g += blockDim.x) mine += a.starts[g];
    int sum;
    block_exclusive_scan(mine, &sum);
    if (tid == 0) a.block_sum[blockIdx.x] = sum;
  }
  grid.sync();
  {
    int before = 0;
    for (int j = tid; j < static_cast<int>(blockIdx.x); j += blockDim.x) {
      before += a.block_sum[j];
    }
    int carry;
    block_exclusive_scan(before, &carry);
    for (int64_t g0 = lo; g0 < hi; g0 += blockDim.x) {
      const int64_t g = g0 + tid;
      const int x = g < hi ? a.starts[g] : 0;
      int tile;
      const int excl = carry + block_exclusive_scan(x, &tile);
      carry += tile;
      int t = 0, start = 0;
      if (g < hi) {
        t = seg_table_of(a, g);
        int u;
        int64_t off;
        seg_table(a, t, &u, &off);
        start = excl - t * n;
        if (x > kSegLong) {
          const int r = atomicAdd(&a.counters[2], 1);
          a.longs[r] = make_int4(t, static_cast<int>(g - off), start, x);
          a.starts[g] = -1 - start;
        } else {
          if (x > kSegSmall) {
            const int r = atomicAdd(&a.counters[1], 1);
            a.medium[r] = make_int4(t, start, x, 0);
          }
          a.starts[g] = start + x;
        }
      }
      const bool short_run = g < hi && x > 1 && x <= kSegSmall;
      const unsigned listed = __ballot_sync(0xffffffffu, short_run);
      if (listed != 0) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&a.counters[0], __popc(listed));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (short_run) {
          a.shorts[base + __popc(listed & lanes_below())] =
              make_int4(t, start, x, 0);
        }
      }
    }
  }
  grid.sync();

  // 4. Place every position of a run that is not long at --end of its key;
  // count each long run's positions per chunk.
  const int n_long = *static_cast<volatile int*>(&a.counters[2]);
  const int items = n_long * a.chunks;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int r = it / a.chunks;
    const int c = it - r * a.chunks;
    const int4 lr = a.longs[r];
    int u;
    int64_t off;
    seg_table(a, lr.x, &u, &off);
    const int first = c * a.chunk;
    const int last = first + a.chunk < n ? first + a.chunk : n;
    const int64_t row = static_cast<int64_t>(lr.x) * n;
    int hits = 0;
    for (int i0 = first; i0 < last; i0 += blockDim.x) {
      const int i = i0 + tid;
      hits += __syncthreads_count(i < last && seg_key(a, row + i, u) == lr.y);
    }
    if (tid == 0) a.long_count[it] = hits;
  }
  for (int b = gtid - lane; b < total; b += nthreads) {
    const int p = b + lane;
    int t = 0, i = 0;
    long long g = -1;
    if (p < total) {
      t = p / n;
      i = p - t * n;
      int u;
      int64_t off;
      seg_table(a, t, &u, &off);
      g = off + seg_key(a, p, u);
      // A long run's entry is negative and does not change in this phase.
      if (a.starts[g] < 0) g = -1;
    }
    const unsigned peers =
        __match_any_sync(0xffffffffu, static_cast<unsigned long long>(g));
    const int leader = __ffs(peers) - 1;
    int end = 0;
    if (g >= 0 && lane == leader) end = atomicSub(&a.starts[g], __popc(peers));
    end = __shfl_sync(0xffffffffu, end, leader);
    if (g >= 0) {
      a.order[static_cast<int64_t>(t) * n + end - 1 -
              __popc(peers & lanes_below())] = i;
    }
  }
  grid.sync();

  // 5. Order within each run. Long runs: stable compaction of each chunk
  // from the count of the chunks before it.
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int r = it / a.chunks;
    const int c = it - r * a.chunks;
    const int4 lr = a.longs[r];
    int u;
    int64_t off;
    seg_table(a, lr.x, &u, &off);
    int before = 0;
    for (int j = tid; j < c; j += blockDim.x) {
      before += a.long_count[r * a.chunks + j];
    }
    int base;
    block_exclusive_scan(before, &base);
    base += lr.z;
    const int64_t row = static_cast<int64_t>(lr.x) * n;
    const int first = c * a.chunk;
    const int last = first + a.chunk < n ? first + a.chunk : n;
    for (int i0 = first; i0 < last; i0 += blockDim.x) {
      const int i = i0 + tid;
      const int hit = (i < last && seg_key(a, row + i, u) == lr.y) ? 1 : 0;
      int tile;
      const int place = base + block_exclusive_scan(hit, &tile);
      if (hit) a.order[row + place] = i;
      base += tile;
    }
    if (c == 0 && tid == 0) a.starts[off + lr.y] = lr.z;
  }
  // Runs of kSegSmall < length <= kSegLong: one block sorts each in shared
  // memory (bitonic, padded to a power of two with INT32_MAX).
  const int n_medium = *static_cast<volatile int*>(&a.counters[1]);
  for (int r = blockIdx.x; r < n_medium; r += gridDim.x) {
    const int4 m = a.medium[r];
    int32_t* o = a.order + static_cast<int64_t>(m.x) * n + m.y;
    int p2 = 1;
    while (p2 < m.z) p2 <<= 1;
    for (int j = tid; j < p2; j += blockDim.x) {
      run[j] = j < m.z ? o[j] : INT32_MAX;
    }
    __syncthreads();
    for (int k = 2; k <= p2; k <<= 1) {
      for (int s = k >> 1; s > 0; s >>= 1) {
        for (int j = tid; j < p2; j += blockDim.x) {
          const int partner = j ^ s;
          if (partner > j) {
            const int x = run[j];
            const int y = run[partner];
            if ((x > y) == ((j & k) == 0)) {
              run[j] = y;
              run[partner] = x;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int j = tid; j < m.z; j += blockDim.x) o[j] = run[j];
    __syncthreads();
  }
  // Runs of 2 to kSegSmall positions: a thread loads one into registers
  // (the loads issued together), sorts it by odd-even transposition and
  // stores it back.
  const int n_short = *static_cast<volatile int*>(&a.counters[0]);
  for (int r = gtid; r < n_short; r += nthreads) {
    const int4 sr = a.shorts[r];
    int32_t* o = a.order + static_cast<int64_t>(sr.x) * n + sr.y;
    int v[kSegSmall];
#pragma unroll
    for (int j = 0; j < kSegSmall; ++j) v[j] = j < sr.z ? o[j] : INT32_MAX;
#pragma unroll
    for (int round = 0; round < kSegSmall; ++round) {
#pragma unroll
      for (int j = round & 1; j + 1 < kSegSmall; j += 2) {
        const int x = min(v[j], v[j + 1]);
        v[j + 1] = max(v[j], v[j + 1]);
        v[j] = x;
      }
    }
#pragma unroll
    for (int j = 0; j < kSegSmall; ++j) {
      if (j < sr.z) o[j] = v[j];
    }
  }
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

// One wave of resident blocks of `kernel` (`per_sm`: its occupancy, read
// once), or `need` blocks when fewer do.
template <typename K>
cudaError_t wave_blocks(K kernel, int threads, int64_t need,
                        std::atomic<int>& per_sm, unsigned* blocks,
                        int smem = 0) {
  int dev, sms, optin;
  cudaError_t err = device_facts(&dev, &sms, &optin);
  if (err != cudaSuccess) return err;
  int occ = per_sm.load();
  if (occ == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    occ = occ < 1 ? 1 : occ;
    per_sm.store(occ);
  }
  const int64_t wave = static_cast<int64_t>(occ) * sms;
  if (need > wave) need = wave;
  *blocks = static_cast<unsigned>(need < 1 ? 1 : need);
  return cudaSuccess;
}

template <typename C, int kT, int kP>
cudaError_t launch_take(const TakeArgs& a, cudaStream_t s) {
  static std::atomic<int> per_sm{0};
  const dim3 block = take_block(a.chunks);
  const int64_t group = static_cast<int64_t>(block.y) * kP;
  unsigned blocks;
  cudaError_t err = wave_blocks(take_fwd_kernel<C, kT, kP>, kThreads,
                                (a.n + group - 1) / group, per_sm, &blocks);
  if (err != cudaSuccess) return err;
  take_fwd_kernel<C, kT, kP><<<blocks, block, 0, s>>>(a);
  return cudaGetLastError();
}

// The short runs' kernel (C: its chunk), then the long runs' (V: its unit)
// on the same stream, which reads the long runs the first one marked.
template <typename C, typename V>
cudaError_t launch_take_bwd(const TakeBwdArgs& a, cudaStream_t s) {
  static std::atomic<int> lane_per_sm{0};
  static std::atomic<int> group_per_sm{0};
  static std::atomic<int> long_per_sm{0};
  static std::atomic<int> long_smem_set[kMaxDevices];
  const bool lane = a.group == 1;
  const int warps = kThreads / 32;
  unsigned blocks;
  cudaError_t err = wave_blocks(
      lane ? take_bwd_lane_kernel<C> : take_bwd_kernel<C>, kThreads,
      (a.warps + warps - 1) / warps, lane ? lane_per_sm : group_per_sm,
      &blocks);
  if (err != cudaSuccess) return err;
  if (lane) {
    take_bwd_lane_kernel<C><<<blocks, kThreads, 0, s>>>(a);
  } else {
    take_bwd_kernel<C><<<blocks, kThreads, 0, s>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int dev, sms, optin;
  err = device_facts(&dev, &sms, &optin);
  if (err != cudaSuccess) return err;
  if (long_smem_set[dev].load() == 0) {
    err = cudaFuncSetAttribute(take_bwd_long_kernel<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kLongRing);
    if (err != cudaSuccess) return err;
    long_smem_set[dev].store(1);
  }
  err = wave_blocks(take_bwd_long_kernel<V>, kLongThreads, INT32_MAX,
                    long_per_sm, &blocks, kLongRing);
  if (err != cudaSuccess) return err;
  take_bwd_long_kernel<V><<<blocks, kLongThreads, kLongRing, s>>>(a);
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

// g [n, d] of `dtype` (0 = float32, 1 = bfloat16); order, starts, out:
// host arrays of t device pointers to int32 [n], int32 [u[i]+1] and [u[i],
// d] of `dtype`; 1 <= t <= 8, u[i] >= 1; long_mask: int32 [sum over i of
// ceil(u[i] / 32)], scratch whose content is ignored; stats: null, or
// int64 [2] in device memory or pinned host memory, which receives the
// long runs the launch took and their positions. The segment sum above for
// every table: the short runs' launch, then the long runs'. Same error
// return as the plan build.
extern "C" int dfm_take_bwd(const void* g, const void* const* order,
                            const void* const* starts, void* const* out,
                            const int64_t* u, int t, int64_t n, int64_t d,
                            int dtype, void* long_mask, void* stats,
                            void* stream) {
  if (t < 1 || t > kMaxTables || n < 0 || n >= INT32_MAX || d <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t item = dtype == 0 ? 4 : 2;
  const int64_t row_bytes = d * item;
  TakeBwdArgs a = {};
  uintptr_t addr = reinterpret_cast<uintptr_t>(g);
  int64_t warps = 0;
  for (int i = 0; i < t; ++i) {
    if (u[i] < 1 || u[i] >= INT32_MAX - 32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.order[i] = static_cast<const int32_t*>(order[i]);
    a.starts[i] = static_cast<const int32_t*>(starts[i]);
    a.out[i] = out[i];
    a.u[i] = static_cast<int>(u[i]);
    warps += (u[i] + 31) / 32;
    if (warps >= INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    a.warp_end[i] = static_cast<int>(warps);
    addr |= reinterpret_cast<uintptr_t>(out[i]);
  }
  // The widest chunk that divides a row and every base address.
  int64_t chunk = dtype == 0 ? 16 : item;
  while (chunk > item && (row_bytes % chunk != 0 || addr % chunk != 0)) {
    chunk >>= 1;
  }
  if (row_bytes / chunk >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (long_mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.g = g;
  a.long_mask = static_cast<uint32_t*>(long_mask);
  if (stats != nullptr) {  // pinned host memory: its device address
    cudaPointerAttributes attr;
    cudaError_t err = cudaPointerGetAttributes(&attr, stats);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.devicePointer == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.stats = static_cast<long long*>(attr.devicePointer);
  }
  a.warps = static_cast<int>(warps);
  a.tables = t;
  a.chunks = static_cast<int>(row_bytes / chunk);
  a.group = 1;
  while (a.group < a.chunks && a.group < 32) a.group <<= 1;
  a.lchunks = a.chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {  // the long runs' units: bfloat16 pairs where aligned
    if (row_bytes % 4 == 0 && addr % 4 == 0) {
      a.lchunks = static_cast<int>(row_bytes / 4);
      return static_cast<int>(
          launch_take_bwd<__nv_bfloat16, __nv_bfloat162>(a, s));
    }
    return static_cast<int>(
        launch_take_bwd<__nv_bfloat16, __nv_bfloat16>(a, s));
  }
  switch (chunk) {
    case 16: return static_cast<int>(launch_take_bwd<float4, float4>(a, s));
    case 8: return static_cast<int>(launch_take_bwd<float2, float2>(a, s));
    default: return static_cast<int>(launch_take_bwd<float, float>(a, s));
  }
}

// ptrs: host array of 8 t device pointers, table i's at [8i, 8i + 8): w, m,
// v (float32 [h, d[i]]), tau (int32 [h]), wv, mv, vv (float32 [p, d[i]]),
// tv (int32 [p]); slots int32 [p]; 1 <= t <= 8. The transaction above for
// every table, in place, one launch. Same error return as the plan build;
// p = 0 launches nothing.
extern "C" int dfm_install(const void* const* ptrs, const int64_t* d, int t,
                           const void* slots, int64_t h, int64_t p,
                           void* stream) {
  if (t < 1 || t > kMaxTables || h <= 0 || h >= INT32_MAX || p < 0 ||
      p >= INT32_MAX - 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p == 0) return 0;
  InstallArgs a = {};
  for (int i = 0; i < t; ++i) {
    const void* const* q = ptrs + 8 * i;
    if (d[i] <= 0 || d[i] >= INT32_MAX / 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    InstallTable& tb = a.tab[i];
    tb.w = static_cast<uint32_t*>(const_cast<void*>(q[0]));
    tb.m = static_cast<uint32_t*>(const_cast<void*>(q[1]));
    tb.v = static_cast<uint32_t*>(const_cast<void*>(q[2]));
    tb.tau = static_cast<int32_t*>(const_cast<void*>(q[3]));
    tb.wv = static_cast<const uint32_t*>(q[4]);
    tb.mv = static_cast<const uint32_t*>(q[5]);
    tb.vv = static_cast<const uint32_t*>(q[6]);
    tb.tv = static_cast<const int32_t*>(q[7]);
    uintptr_t addr = 0;
    for (int j = 0; j < 7; ++j) {
      if (j != 3) addr |= reinterpret_cast<uintptr_t>(q[j]);
    }
    const int64_t row_bytes = 4 * d[i];
    int64_t chunk = 16;
    while (chunk > 4 && (row_bytes % chunk != 0 || addr % chunk != 0)) {
      chunk >>= 1;
    }
    tb.chunk = static_cast<int>(chunk);
    tb.chunks = static_cast<int>(row_bytes / chunk);
    tb.group = 1;
    while (tb.group < tb.chunks && tb.group < 32) tb.group <<= 1;
  }
  a.slots = static_cast<const int32_t*>(slots);
  a.tables = t;
  a.h = static_cast<int>(h);
  a.p = static_cast<int>(p);
  static std::atomic<int> per_sm{0};
  const int warps = kInstallThreads / 32;
  unsigned blocks;
  cudaError_t err = wave_blocks(install_kernel, kInstallThreads,
                                ((p + 31) / 32 * t + warps - 1) / warps,
                                per_sm, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  install_kernel<<<blocks, kInstallThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Scratch of dfm_segments for t tables of n positions: the counters, the
// block sums, the three run lists (a listed run holds 2 or more, more than
// kSegSmall, or more than kSegLong of the t * n positions) and the long
// runs' chunk counts, at 16-byte boundaries. A long run's chunk is at least
// 512 positions, and larger where that keeps a table to 256 chunks.
struct SegScratch {
  int64_t block_sum, shorts, medium, longs, long_count, bytes;
  int64_t chunk, chunks;
};

SegScratch seg_scratch(int t, int64_t n) {
  SegScratch s;
  const int64_t positions = t * n;
  const int64_t max_long = positions / (kSegLong + 1) + 1;
  s.chunk = ((n + 255) / 256 + 511) / 512 * 512;
  s.chunk = s.chunk < 512 ? 512 : s.chunk;
  s.chunks = (n + s.chunk - 1) / s.chunk;
  s.block_sum = 16;
  s.shorts = s.block_sum + 4 * kSegMaxBlocks;
  s.medium = s.shorts + 16 * (positions / 2 + 1);
  s.longs = s.medium + 16 * (positions / (kSegSmall + 1) + 1);
  s.long_count = s.longs + 16 * max_long;
  s.bytes = s.long_count + (4 * max_long * s.chunks + 15) / 16 * 16;
  return s;
}

}  // namespace

// Bytes of device scratch dfm_segments needs for t tables of n positions
// (-1 for arguments it refuses).
extern "C" int64_t dfm_segments_scratch(int t, int64_t n) {
  if (t < 1 || t > kMaxTables || n < 0 || t * n > kSegMaxPositions) return -1;
  return seg_scratch(t, n).bytes;
}

// inv: [t, n] int32 (wide = 0) or int64 (wide = 1); keep: null or [t, n]
// bool; u: host array of the t slot counts; order int32 [t, n]; starts
// int32, the tables' [u[i] + 1] end to end; scratch: dfm_segments_scratch
// bytes, its content ignored. The position segments above for every table,
// one cooperative launch. Same error return as the plan build.
extern "C" int dfm_segments(const void* inv, int wide, const void* keep,
                            const int64_t* u, int t, int64_t n, void* order,
                            void* starts, void* scratch, int64_t scratch_bytes,
                            void* stream) {
  if (t < 1 || t > kMaxTables || n < 0 || t * n > kSegMaxPositions ||
      (wide != 0 && wide != 1) || u == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SegScratch s = seg_scratch(t, n);
  if (scratch_bytes < s.bytes) return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  SegArgs a = {};
  a.inv = inv;
  a.keep = static_cast<const uint8_t*>(keep);
  a.order = static_cast<int32_t*>(order);
  a.starts = static_cast<int32_t*>(starts);
  a.counters = reinterpret_cast<int*>(base);
  a.block_sum = reinterpret_cast<int*>(base + s.block_sum);
  a.shorts = reinterpret_cast<int4*>(base + s.shorts);
  a.medium = reinterpret_cast<int4*>(base + s.medium);
  a.longs = reinterpret_cast<int4*>(base + s.longs);
  a.long_count = reinterpret_cast<int*>(base + s.long_count);
  int64_t slots = 0;
  for (int i = 0; i < t; ++i) {
    if (u[i] < 0 || u[i] >= INT32_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.u[i] = static_cast<int>(u[i]);
    a.off[i] = slots;
    slots += u[i] + 1;
  }
  a.slots = slots;
  a.tables = t;
  a.n = static_cast<int>(n);
  a.wide = wide;
  a.chunk = static_cast<int>(s.chunk);
  a.chunks = static_cast<int>(s.chunks);
  static std::atomic<int> per_sm{0};
  unsigned blocks;
  cudaError_t err = wave_blocks(segments_kernel, kSegThreads,
                                int64_t{kSegMaxBlocks}, per_sm, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev, sms, optin;
  err = device_facts(&dev, &sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned most = static_cast<unsigned>(sms * kSegBlocksPerSm);
  if (blocks > most) blocks = most;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(segments_kernel),
                                    dim3(blocks), dim3(kSegThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
