// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_rms_kernel` (tony_tpu/ops/rmsnorm.py:26),
// launched by `_rms_pallas` (tony_tpu/ops/rmsnorm.py:33).
//
// Computes, per row of x (rows, d): y = x * rsqrt(mean(x^2) + eps) * w, with
// the mean of squares, rsqrt and the scale in f32 and the result cast back to
// x's dtype. The weight is f32.
//
// What bounds it on this card: bytes. Each element is read, squared and
// scaled once: about 3 flops for every 2 (bf16) or 4 (f32) bytes of x moved,
// far below the ~295 flops per byte where Hopper's arithmetic becomes the
// limit. The least time is (2 * rows * d * itemsize + 4 * d) / memory rate.
//
// What the design does about it: one block of 256 threads per row, so every
// row is a single pass with no padding of the row count (the TPU kernel
// padded rows to 256-row blocks). Neighbouring threads read neighbouring
// elements, so each warp's loads coalesce. The sum of squares is reduced by
// warp shuffles and then across the block's 8 warps in shared memory. The row
// is read a second time for the scale; at d = 4096 a row is 8 KB, so the
// second read hits L1/L2 rather than device memory. Vector loads and holding
// the row in registers are left to a later change.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[kWarps];
  __shared__ float rstd;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float total = lane < kWarps ? warp_sums[lane] : 0.f;
    total = warp_sum(total);
    if (lane == 0) rstd = rsqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = rstd;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    outr[i] = from_f32<T>(to_f32(xr[i]) * r * w[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  rmsnorm_fwd_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the dtype of x and out; w is float32).
extern "C" int tt_rmsnorm_fwd(const void* x, const void* w, void* out,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, w, out, rows, d, eps, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, w, out, rows, d, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
