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
// limit. The least time is (2 * rows * d * itemsize + 4 * d) / memory rate:
// 9.8 us at 2000 x 4096 bf16 and 40 us at 16384 x 2048 on the H100's
// 3.35 TB/s. So x must cross from memory once, in wide accesses, and enough
// of it must be in flight.
//
// What the design does about it. Two paths, picked on the host before the
// launch from the shape and the addresses (a dispatch on shape, not a
// fallback: both do the same f32 arithmetic and give the same numbers):
// - the vector path, where a row is a whole number of 16-byte vectors
//   (d * itemsize % 16 == 0), x, w and out are 16-byte aligned and a row is
//   at most 1024 vectors (16 KB). A row belongs to `kRowThreads` threads, the
//   fewest of 32, 64, 128 or 256 that hold it in 4 vectors each (d 4096 bf16:
//   128 threads; d 1024 bf16: one warp), so a block of 256 threads does 1 to 8
//   rows and no thread idles at small d. Each thread loads its vectors (8
//   bf16 or 4 f32, neighbouring threads on neighbouring 16 bytes) into
//   registers, sums their squares, the row's threads reduce by warp shuffles
//   and, past one warp, through shared memory; then the same registers are
//   scaled by the rsqrt and the weight (read as float4) and stored as 16-byte
//   vectors. x is read from memory once.
// - the scalar path, for any other row: one block of 256 threads per row,
//   element by element, the row read a second time for the scale (from L1 or
//   L2).
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte vectors a thread of the vector path holds

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// scalar conversions, and 16 bytes of T as kN floats and back
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16(v);
  }
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[kN]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(p[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[kN]) {
    uint4 u;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
    return u;
  }
};

template <typename T, int kRowThreads>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_vec(const T* __restrict__ x, const float* __restrict__ w,
                T* __restrict__ out, int rows, int d, float eps) {
  using E = Elem<T>;
  constexpr int kRowsPerBlock = kThreads / kRowThreads;
  constexpr int kRowWarps = kRowThreads / 32;
  __shared__ float partial[kThreads / 32];
  const int t = threadIdx.x % kRowThreads;
  const int sub = threadIdx.x / kRowThreads;  // the block's row
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + sub;
  const bool live = row < rows;
  const int n_vec = d / E::kN;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* outr = reinterpret_cast<uint4*>(out + row * d);
  const float4* w4 = reinterpret_cast<const float4*>(w);

  float xv[kVecs][E::kN];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = t + i * kRowThreads;
    if (live && j < n_vec) {
      E::unpack(xr[j], xv[i]);
#pragma unroll
      for (int e = 0; e < E::kN; ++e) ss = fmaf(xv[i][e], xv[i][e], ss);
    }
  }
  ss = warp_sum(ss);
  if constexpr (kRowWarps > 1) {
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < kRowWarps; ++i) ss += partial[sub * kRowWarps + i];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = t + i * kRowThreads;
    if (live && j < n_vec) {
      float y[E::kN];
#pragma unroll
      for (int e = 0; e < E::kN; e += 4) {
        const float4 wv = w4[j * (E::kN / 4) + e / 4];
        y[e] = xv[i][e] * r * wv.x;
        y[e + 1] = xv[i][e + 1] * r * wv.y;
        y[e + 2] = xv[i][e + 2] * r * wv.z;
        y[e + 3] = xv[i][e + 3] * r * wv.w;
      }
      outr[j] = E::pack(y);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_scalar(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int d, float eps) {
  using E = Elem<T>;
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_sums[kWarps];
  __shared__ float rstd;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = E::to_f32(xr[i]);
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
    outr[i] = E::from_f32(E::to_f32(xr[i]) * r * w[i]);
  }
}

template <typename T, int kRowThreads>
cudaError_t launch_vec(const void* x, const void* w, void* out, int rows,
                       int d, float eps, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / kRowThreads;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_vec<T, kRowThreads><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const size_t n_vec = row_bytes / 16;
  if (row_bytes % 16 == 0 && n_vec <= static_cast<size_t>(kThreads * kVecs) &&
      aligned16(x) && aligned16(w) && aligned16(out)) {
    if (n_vec <= 32 * kVecs) {
      return launch_vec<T, 32>(x, w, out, rows, d, eps, stream);
    }
    if (n_vec <= 64 * kVecs) {
      return launch_vec<T, 64>(x, w, out, rows, d, eps, stream);
    }
    if (n_vec <= 128 * kVecs) {
      return launch_vec<T, 128>(x, w, out, rows, d, eps, stream);
    }
    return launch_vec<T, 256>(x, w, out, rows, d, eps, stream);
  }
  rmsnorm_scalar<T><<<rows, kThreads, 0, stream>>>(
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
