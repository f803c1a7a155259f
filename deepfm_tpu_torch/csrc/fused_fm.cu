// Fused first-order + FM second-order forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepfm_tpu/ops/pallas_fm.py `_fwd_kernel`. Per row b:
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
cudaError_t launch(const void* w, const void* vals, const void* xv, void* out,
                   int64_t batch, int fields, int k_dim, cudaStream_t stream) {
  const int64_t blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fm_fwd_kernel<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                     stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(vals),
      static_cast<const T*>(xv), static_cast<float*>(out), batch, fields,
      k_dim);
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
