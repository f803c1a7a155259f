// Fused first-order + FM second-order forward and backward for Hopper
// (sm_90a).
//
// Forward: replaces the TPU kernel deepfm_tpu/ops/pallas_fm.py `_fwd_kernel`.
// Per row b:
//
//   y[b] = sum_f w[b,f]*vals[b,f]
//        + 0.5 * ( sum_k (sum_f xv[b,f,k])^2 - sum_{f,k} xv[b,f,k]^2 )
//
// Inputs w, vals [B,F] and xv [B,F,K], all float32 or all bfloat16,
// contiguous; output [B] float32. Values are converted to float32 after the
// load and every sum is taken in float32.
//
// Bound: device-memory bytes. Each input element is read once and used for
// two or three flops, far below the card's ratio of operations to bytes, so
// the least time is B*F*(K+2)*sizeof(T) + 4*B bytes over the memory rate.
// At the serving shape (B=256, F=39, K=32, f32) that is ~1.36 MB, 0.41 us;
// at the training shape (B=1024) ~5.4 MB, 1.62 us at 3.35 TB/s.
//
// What held the first design back (one warp per row, lane k walking the F
// fields of column k with 4-byte loads): a lane's F loads formed a chain
// behind a runtime loop bound rather than loads in flight, and at B=256
// its 64 blocks of 4 warps left half of the 132 SMs idle, so B=256 took as
// long as B=1024 (0.0044 and 0.0046 ms on an H100 80GB HBM3 at 700 W, 9%
// and 35% of their bounds).
//
// Design (the vector path): a row of xv is F*K*sizeof(T) contiguous bytes,
// read as 16-byte chunks, C = K*sizeof(T)/16 of them per field (8 at K=32
// float32). A row belongs to a group of kTpr threads (32 to 256, chosen on
// the host so that the card holds about kFwdTargetThreads threads: 32 per
// row at B=1024, 128 at B=256, so both make 128 blocks of 256 threads;
// twice that many threads measured slower on an H100), and thread t of
// the group takes chunks t, t + kTpr, ...: as C divides 32, always the same
// chunk column of the fields (columns (t mod C)*16/sizeof(T) onward of K).
// It issues up
// to kFwdLoads chunk loads before its first add, with the row's w and vals
// loads ahead of them, and keeps per-column partial sums s and a partial
// sum of squares q. Lanes of a warp that share a column add their s by
// shuffles; the warps of a row add theirs through shared memory; the first
// warp of the row squares the column sums and writes y. Nothing is padded:
// a group whose row lies past B loads nothing and writes nothing.
//
// The scalar path: shapes and pointers that cannot take 16-byte chunks (C
// not a divisor of 32, or xv not 16-byte aligned) take the first design,
// one warp per row, lane k summing column k, chosen in the C entry.
//
// Backward: replaces the TPU kernel deepfm_tpu/ops/pallas_fm.py
// `_bwd_kernel`. Given the float32 cotangent g [B] of y:
//
//   dw[b,f]     = vals[b,f] * g[b]
//   dvals[b,f]  = w[b,f] * g[b]
//   dxv[b,f,k]  = (sum_f' xv[b,f',k] - xv[b,f,k]) * g[b]
//
// Products are taken in float32 and each cotangent is rounded to its
// primal's type (float32 or bfloat16), as the TPU kernel writes them.
//
// Bound: device-memory bytes. The kernel reads w, vals, xv and g once
// (B*F*(K+2)*sizeof(T) + 4*B bytes) and writes dw, dvals, dxv once
// (B*F*(K+2)*sizeof(T)): 10,866,688 bytes at the training shape (B=1024,
// F=39, K=32, float32), 3.24 us at 3.35 TB/s; about half that in bfloat16.
// About two flops per element, so bytes bound it by two orders of magnitude.
//
// Design: one warp per row, as the forward. Lane k sums column k over the F
// fields (s_k, in a register), then walks the F fields a second time writing
// (s_k - xv[f,k]) * g: both passes read one contiguous K-wide segment per
// field across the warp, and the second pass finds the row (F*K*4 = 5 KB at
// the training shape) in L1. The lanes then stride over F for dw and dvals.
// No shuffles are needed, so a ragged last warp is harmless.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;        // scalar forward and backward
constexpr int kFwdThreads = 256;         // vector forward blocks
constexpr int kFwdLoads = 6;             // chunk loads in flight a thread
constexpr int64_t kFwdTargetThreads = 32768;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// The float32 values of one 16-byte chunk of T.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kValues = 4;
  __device__ __forceinline__ static void unpack(const uint4& c, float* x) {
    x[0] = __uint_as_float(c.x);
    x[1] = __uint_as_float(c.y);
    x[2] = __uint_as_float(c.z);
    x[3] = __uint_as_float(c.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kValues = 8;
  __device__ __forceinline__ static void unpack(const uint4& c, float* x) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// The vector path of the header note: kTpr threads per row, kFwdThreads /
// kTpr rows per block, `chunks` (C, a divisor of 32) 16-byte chunks per
// field.
template <typename T, int kTpr>
__global__ void __launch_bounds__(kFwdThreads)
fm_fwd_vec_kernel(const T* __restrict__ w, const T* __restrict__ vals,
                  const uint4* __restrict__ xv, float* __restrict__ out,
                  int64_t batch, int fields, int chunks) {
  constexpr int kV = Chunk<T>::kValues;
  constexpr int kWarps = kTpr / 32;           // warps of a row
  __shared__ float part_s[kFwdThreads / 32][32 * kV];
  __shared__ float part_q[kFwdThreads / 32];
  __shared__ float part_y[kFwdThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x % kTpr;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kFwdThreads / kTpr)
                      + threadIdx.x / kTpr;
  const bool valid = row < batch;
  const int n = valid ? fields * chunks : 0;  // chunks of this row

  // The row's first-order terms, loaded ahead of the chunks.
  const int64_t wb = row * fields;
  float w0 = 0.f, v0 = 0.f, w1 = 0.f, v1 = 0.f;
  if (valid && t < fields) {
    w0 = to_f32(w[wb + t]);
    v0 = to_f32(vals[wb + t]);
  }
  if (valid && t + kTpr < fields) {
    w1 = to_f32(w[wb + t + kTpr]);
    v1 = to_f32(vals[wb + t + kTpr]);
  }

  const uint4* xr = xv + row * static_cast<int64_t>(fields) * chunks;
  float s[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) s[v] = 0.f;
  float q = 0.f;
  for (int base = t; base < n; base += kFwdLoads * kTpr) {
    uint4 c[kFwdLoads];
#pragma unroll
    for (int u = 0; u < kFwdLoads; ++u) {
      const int i = base + u * kTpr;
      c[u] = i < n ? __ldg(xr + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kFwdLoads; ++u) {
      float x[kV];
      Chunk<T>::unpack(c[u], x);
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        s[v] += x[v];
        q = fmaf(x[v], x[v], q);
      }
    }
  }
  float y = w0 * v0 + w1 * v1;
  for (int f = t + 2 * kTpr; f < fields; f += kTpr) {
    y += to_f32(w[wb + f]) * to_f32(vals[wb + f]);
  }

  // Lanes l and l ^ (m * C) share a column: after these shuffles every lane
  // holds its warp's sums of its column.
  for (int off = 16; off >= chunks; off >>= 1) {
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      s[v] += __shfl_xor_sync(0xffffffffu, s[v], off);
    }
  }
  q = warp_sum(q);
  y = warp_sum(y);
  if (kWarps == 1) {
    float ss = 0.f;
    if (lane < chunks) {
#pragma unroll
      for (int v = 0; v < kV; ++v) ss += s[v] * s[v];
    }
    ss = warp_sum(ss);
    if (valid && lane == 0) out[row] = y + 0.5f * (ss - q);
    return;
  }
  if (lane < chunks) {
#pragma unroll
    for (int v = 0; v < kV; ++v) part_s[warp][lane * kV + v] = s[v];
  }
  if (lane == 0) {
    part_q[warp] = q;
    part_y[warp] = y;
  }
  __syncthreads();
  if (!valid || t >= 32) return;
  // The row's first warp: column sums over the row's warps, squared.
  const int first = warp;  // t < 32: this is the row's first warp
  float ss = 0.f;
  for (int k = lane; k < chunks * kV; k += 32) {
    float col = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) col += part_s[first + j][k];
    ss += col * col;
  }
  ss = warp_sum(ss);
  if (lane == 0) {
    float qs = 0.f, ys = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      qs += part_q[first + j];
      ys += part_y[first + j];
    }
    out[row] = ys + 0.5f * (ss - qs);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fm_fwd_kernel(const T* __restrict__ w, const T* __restrict__ vals,
              const T* __restrict__ xv, float* __restrict__ out,
              int64_t batch, int fields, int k_dim) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= batch) return;  // the whole warp shares one row

  const T* xr = xv + row * fields * k_dim;
  float sum_sq = 0.f;  // this lane's share of sum_k s_k^2
  float sq_sum = 0.f;  // this lane's share of sum_{f,k} xv^2
  for (int k = lane; k < k_dim; k += 32) {
    float s = 0.f, q = 0.f;
    for (int f = 0; f < fields; ++f) {
      const float x = to_f32(xr[f * k_dim + k]);
      s += x;
      q += x * x;
    }
    sum_sq += s * s;
    sq_sum += q;
  }

  const T* wr = w + row * fields;
  const T* vr = vals + row * fields;
  float y_w = 0.f;
  for (int f = lane; f < fields; f += 32) {
    y_w += to_f32(wr[f]) * to_f32(vr[f]);
  }

  y_w = warp_sum(y_w);
  sum_sq = warp_sum(sum_sq);
  sq_sum = warp_sum(sq_sum);
  if (lane == 0) out[row] = y_w + 0.5f * (sum_sq - sq_sum);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fm_bwd_kernel(const float* __restrict__ g, const T* __restrict__ w,
              const T* __restrict__ vals, const T* __restrict__ xv,
              T* __restrict__ dw, T* __restrict__ dvals, T* __restrict__ dxv,
              int64_t batch, int fields, int k_dim) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= batch) return;

  const float gr = g[row];
  const int64_t base = row * fields * k_dim;
  const T* xr = xv + base;
  T* dr = dxv + base;
  for (int k = lane; k < k_dim; k += 32) {
    float s = 0.f;
    for (int f = 0; f < fields; ++f) s += to_f32(xr[f * k_dim + k]);
    for (int f = 0; f < fields; ++f) {
      const int i = f * k_dim + k;
      dr[i] = from_f32<T>((s - to_f32(xr[i])) * gr);
    }
  }

  const int64_t off = row * fields;
  for (int f = lane; f < fields; f += 32) {
    dw[off + f] = from_f32<T>(to_f32(vals[off + f]) * gr);
    dvals[off + f] = from_f32<T>(to_f32(w[off + f]) * gr);
  }
}

unsigned blocks_for(int64_t batch) {
  return static_cast<unsigned>((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename T, int kTpr>
cudaError_t launch_vec(const void* w, const void* vals, const void* xv,
                       void* out, int64_t batch, int fields, int chunks,
                       cudaStream_t stream) {
  constexpr int kRows = kFwdThreads / kTpr;
  const int64_t blocks = (batch + kRows - 1) / kRows;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  fm_fwd_vec_kernel<T, kTpr><<<static_cast<unsigned>(blocks), kFwdThreads, 0,
                               stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(vals),
      static_cast<const uint4*>(xv), static_cast<float*>(out), batch, fields,
      chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* w, const void* vals, const void* xv, void* out,
                   int64_t batch, int fields, int k_dim, cudaStream_t stream) {
  const int64_t row_bytes = static_cast<int64_t>(k_dim) * sizeof(T);
  const int64_t chunks = row_bytes / 16;
  const bool vector = row_bytes % 16 == 0 && chunks >= 1 && chunks <= 32 &&
                      32 % chunks == 0 &&
                      reinterpret_cast<uintptr_t>(xv) % 16 == 0 &&
                      static_cast<int64_t>(fields) * chunks < INT32_MAX;
  if (!vector) {
    fm_fwd_kernel<T><<<blocks_for(batch), kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const T*>(w), static_cast<const T*>(vals),
        static_cast<const T*>(xv), static_cast<float*>(out), batch, fields,
        k_dim);
    return cudaGetLastError();
  }
  // Threads per row: double from a warp while the card holds fewer than
  // kFwdTargetThreads and every thread keeps a chunk.
  const int64_t per_row = static_cast<int64_t>(fields) * chunks;
  int tpr = 32;
  while (tpr < 256 && batch * tpr < kFwdTargetThreads && 2 * tpr <= per_row) {
    tpr *= 2;
  }
  const int c = static_cast<int>(chunks);
  switch (tpr) {
    case 32:
      return launch_vec<T, 32>(w, vals, xv, out, batch, fields, c, stream);
    case 64:
      return launch_vec<T, 64>(w, vals, xv, out, batch, fields, c, stream);
    case 128:
      return launch_vec<T, 128>(w, vals, xv, out, batch, fields, c, stream);
    default:
      return launch_vec<T, 256>(w, vals, xv, out, batch, fields, c, stream);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* w, const void* vals,
                       const void* xv, void* dw, void* dvals, void* dxv,
                       int64_t batch, int fields, int k_dim,
                       cudaStream_t stream) {
  fm_bwd_kernel<T><<<blocks_for(batch), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const T*>(w),
      static_cast<const T*>(vals), static_cast<const T*>(xv),
      static_cast<T*>(dw), static_cast<T*>(dvals), static_cast<T*>(dxv),
      batch, fields, k_dim);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success); the caller raises on anything else.
extern "C" int dfm_fused_fm_fwd(const void* w, const void* vals,
                                const void* xv, void* out, int64_t batch,
                                int fields, int k_dim, int dtype,
                                void* stream) {
  if (batch <= 0 || fields <= 0 || k_dim <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(w, vals, xv, out, batch, fields, k_dim, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(w, vals, xv, out, batch, fields, k_dim, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g: float32 [B]; w, vals, xv and the outputs dw, dvals [B,F], dxv [B,F,K]
// all of type `dtype` (0 = float32, 1 = bfloat16). Same error return as the
// forward.
extern "C" int dfm_fused_fm_bwd(const void* g, const void* w,
                                const void* vals, const void* xv, void* dw,
                                void* dvals, void* dxv, int64_t batch,
                                int fields, int k_dim, int dtype,
                                void* stream) {
  if (batch <= 0 || fields <= 0 || k_dim <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(
          g, w, vals, xv, dw, dvals, dxv, batch, fields, k_dim, s));
    case 1:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(
          g, w, vals, xv, dw, dvals, dxv, batch, fields, k_dim, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
