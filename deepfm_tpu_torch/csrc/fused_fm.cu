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
// At the serving shape (B=256, F=39, K=32, f32) that is ~1.36 MB, a few
// hundred nanoseconds, so the launch itself dominates a call.
//
// Design: one warp per row. Lane k walks the F fields of column k and keeps
// s_k = sum_f xv and q_k = sum_f xv^2 in registers (lanes stride by 32 when
// K > 32), so the warp reads xv[b,f,:] as one contiguous, coalesced segment
// per field. The lanes then stride over F for sum_f w*vals, and three
// warp-shuffle reductions give sum_k s_k^2, sum_k q_k and the first-order
// sum. Nothing is padded: a warp whose row lies past B returns at once, and
// whole warps exit together, so the shuffles see all 32 lanes.
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

constexpr int kWarpsPerBlock = 4;

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

template <typename T>
cudaError_t launch(const void* w, const void* vals, const void* xv, void* out,
                   int64_t batch, int fields, int k_dim, cudaStream_t stream) {
  fm_fwd_kernel<T><<<blocks_for(batch), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(vals),
      static_cast<const T*>(xv), static_cast<float*>(out), batch, fields,
      k_dim);
  return cudaGetLastError();
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
