// W8A16 product for Hopper (sm_90a): K5, the int8-weight decode product.
//
// Replaces: XLA's fused int8 dequantize -> dot of the JAX package's int8
// inference path (`dequantize`, tony_tpu/models/quant.py:66-69, called inside
// the decode body at tony_tpu/models/generate.py:161-163), where XLA folds
// the int8 load and the channel-scale multiply into the matmul's operand read
// and the bf16 weight never reaches device memory. There is no Pallas kernel
// behind it; this is how the card does what XLA did there.
//
// Computes y[m, n] = sum_k x[m, k] * w[k, n], with
//   w[k, n] = q[k, n] * bf16(scale[n])
// exact in f32 (an int8 times an 8-bit significand), the element the JAX
// package's compiled steps multiply by (XLA keeps the bf16 product of its
// `dequantize` unrounded inside a compiled computation), and the sum in
// f32. The scale is common to a column, so it is applied once to the sum:
// y[m, n] = bf16(scale[n]) * sum_k x[m, k] * q[k, n]. x is (M, K) f32 or bf16, q a (K, N) int8 slice of a stacked
// leaf, scale (N,) f32, y (M, N) bf16 or f32.
//
// What bounds it on this card: bytes. With M <= 16 rows each weight byte
// feeds at most 16 multiply-adds, far below the ~295 operations per byte
// where Hopper's arithmetic becomes the limit; the least time is the int8
// weight's K*N bytes (plus x, scale and y) over the memory rate: 2.24 ms for
// the 7.50 G weights of one llama3_8b decode step at 3.35 TB/s, where bf16
// weights would take 4.48 ms and a dequantize-then-matmul 11.2 ms.
//
// What the design does about it:
// - Each weight byte is read once, in 16-byte loads along N: a thread owns
//   16 neighbouring columns, and a warp a 512-column tile's row, 512
//   contiguous bytes (four whole lines) at a time.
// - The 8 warps of a block stride over the block's K range as 8 k lanes;
//   the block's x rows over that range are staged once in shared memory (as
//   f32; the caller splits K so that they fit) and read there by
//   broadcast, so the weight loads run with no barrier between them.
// - At most 128 registers a thread for MT <= 4 (two blocks per SM), so
//   enough 16-byte loads are in flight.
// - The int8 to f32 conversion costs a byte permute and an add per element
//   (the int8 is placed in the mantissa of 2^23 and the bias subtracted:
//   exact).
// - Each thread keeps kAhead 16-byte loads in flight: a ring of registers
//   refilled with the load kAhead rows ahead as each row is used, so the
//   latency of memory is covered without a barrier.
// - Most products have too few column tiles to fill 132 SMs, so K is split
//   across blocks (`splits`, chosen by the caller to fill whole waves of
//   two blocks per SM); each block writes f32 partial sums and a second
//   kernel adds the splits in order. Within a block the 8 k lanes are added
//   in order through shared memory. The order of every sum is fixed and
//   there are no float atomics, so two calls agree bit for bit.
// - M is taken MT rows at a time (MT in 1, 2, 4, 8; blockIdx.z the row
//   block): the accumulators are MT x 16 floats a thread. M > 8 reads the
//   weights once per 8 rows.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, allocates nothing (the caller gives the split workspace), and
// returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 32;                   // threads along N: a warp
constexpr int kTileN = kColThreads * 16;          // 512 columns a block
constexpr int kLanes = kThreads / kColThreads;    // 8 k lanes: the warps
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;                         // loads in flight a thread
// the most dynamic shared memory a block may ask for (of the 227 KB)
constexpr size_t kMaxSmem = 200 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the 4 int8 of `word` as floats: each int8 is biased by 0x80 to unsigned,
// placed in the mantissa of 2^23 and the bias taken off (exact)
__device__ __forceinline__ void int8x4_to_f32(uint32_t word, float* w) {
  const uint32_t u = word ^ 0x80808080u;
  const float kBias = 8388736.0f;  // 2^23 + 128
  w[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBias;
  w[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBias;
  w[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBias;
  w[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBias;
}

__device__ __forceinline__ uint4 load16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store(float* y, int64_t i, float v) {
  y[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* y, int64_t i, float v) {
  y[i] = __float2bfloat16_rn(v);
}

// One block: a 128-column tile (blockIdx.x), a K range of k_chunk rows
// (blockIdx.y of `splits`), MT rows of x (blockIdx.z). The block's x rows
// of its K range are staged once, as f32, in dynamic shared memory, which
// then holds the cross-warp sums. With one split the result goes straight
// to y in TY; with more, block (y) writes its f32 partial sums to
// part[split][m][n].
template <typename TX, typename TY, int MT>
__global__ void __launch_bounds__(kThreads, MT <= 4 ? 2 : 1)
    w8a16(const TX* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ scale, TY* __restrict__ y,
          float* __restrict__ part, int M, int K, int N, int k_chunk) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int cg = tid % kColThreads;
  const int lane_k = tid / kColThreads;
  const int n0 = blockIdx.x * kTileN + cg * 16;
  const int m0 = blockIdx.z * MT;
  const int k_begin = blockIdx.y * k_chunk;
  const int kn = max(0, min(K, k_begin + k_chunk) - k_begin);
  const bool live = n0 < N;  // N % 16 == 0: a thread's 16 columns all or none

  float* xs = smem;  // [MT][kn]
  for (int i = tid; i < MT * kn; i += kThreads) {
    const int m = i / kn;
    const int kk = i - m * kn;
    xs[i] = m0 + m < M
                ? to_f32(x[static_cast<int64_t>(m0 + m) * K + k_begin + kk])
                : 0.f;
  }
  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;
  }
  __syncthreads();

  if (live) {
    // this thread's rows are lane_k, lane_k + kLanes, ...; row r's load
    // sits in ring[(r - lane_k) / kLanes % kAhead]
    const int8_t* qcol = q + static_cast<int64_t>(k_begin) * N + n0;
    uint4 ring[kAhead];
#pragma unroll
    for (int b = 0; b < kAhead; ++b) {
      const int kk = lane_k + b * kLanes;
      ring[b] = kk < kn ? load16(qcol + static_cast<int64_t>(kk) * N)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int k0 = lane_k; k0 < kn; k0 += kAhead * kLanes) {
#pragma unroll
      for (int b = 0; b < kAhead; ++b) {
        const int kk = k0 + b * kLanes;
        const uint4 w4 = ring[b];
        const int ahead = kk + kAhead * kLanes;
        if (ahead < kn) {
          ring[b] = load16(qcol + static_cast<int64_t>(ahead) * N);
        }
        if (kk < kn) {
          float w[16];
          int8x4_to_f32(w4.x, w);
          int8x4_to_f32(w4.y, w + 4);
          int8x4_to_f32(w4.z, w + 8);
          int8x4_to_f32(w4.w, w + 12);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xs[m * kn + kk];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              acc[m][j] = fmaf(xv, w[j], acc[m][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float sj = bf16_round(scale[n0 + j]);
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m][j] *= sj;
    }
  }

  // the k lanes (the warps) added in order, through the shared memory x
  // used
  __syncthreads();
  float* red = smem;  // [kWarps][MT][kTileN]
  const int warp = tid / 32;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      red[(warp * MT + m) * kTileN + cg * 16 + j] = acc[m][j];
    }
  }
  __syncthreads();
  for (int o = tid; o < MT * kTileN; o += kThreads) {
    const int m = o / kTileN;
    const int c = o % kTileN;
    const int n = blockIdx.x * kTileN + c;
    if (m0 + m >= M || n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[(w * MT + m) * kTileN + c];
    const int64_t at = static_cast<int64_t>(m0 + m) * N + n;
    if (part != nullptr) {
      part[static_cast<int64_t>(blockIdx.y) * M * N + at] = v;
    } else {
      store(y, at, v);
    }
  }
}

// y[i] = sum over the splits, in order, of part[split][i]; the loads are
// issued 8 splits at a time, so they overlap
template <typename TY>
__global__ void __launch_bounds__(kThreads)
    add_splits(const float* __restrict__ part, TY* __restrict__ y,
               int64_t count, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  int s = 0;
  for (; s + 8 <= splits; s += 8) {
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = part[(s + u) * count + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) v += t[u];
  }
  for (; s < splits; ++s) v += part[s * count + i];
  store(y, i, v);
}

template <typename TX, typename TY, int MT>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y,
                   void* part, int M, int K, int N, int splits,
                   cudaStream_t stream) {
  const int k_chunk = (K + splits - 1) / splits;
  const size_t smem = sizeof(float) * static_cast<size_t>(MT) *
                      (k_chunk > kWarps * kTileN ? k_chunk : kWarps * kTileN);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a16<TX, TY, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kTileN - 1) / kTileN, splits, (M + MT - 1) / MT);
  w8a16<TX, TY, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<TY*>(y),
      splits > 1 ? static_cast<float*>(part) : nullptr, M, K, N, k_chunk);
  if (splits > 1) {
    const int64_t count = static_cast<int64_t>(M) * N;
    const int blocks = static_cast<int>((count + kThreads - 1) / kThreads);
    add_splits<TY><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(part), static_cast<TY*>(y), count, splits);
  }
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_rows(const void* x, const void* q, const void* scale,
                        void* y, void* part, int M, int K, int N, int splits,
                        cudaStream_t stream) {
  if (M <= 1) return launch<TX, TY, 1>(x, q, scale, y, part, M, K, N, splits, stream);
  if (M <= 2) return launch<TX, TY, 2>(x, q, scale, y, part, M, K, N, splits, stream);
  if (M <= 4) return launch<TX, TY, 4>(x, q, scale, y, part, M, K, N, splits, stream);
  return launch<TX, TY, 8>(x, q, scale, y, part, M, K, N, splits, stream);
}

}  // namespace

// x_dtype, y_dtype: 0 = float32, 1 = bfloat16. q (K, N) int8 and x, y
// 16-byte aligned, N % 16 == 0; part holds splits * M * N floats when
// splits > 1.
extern "C" int tt_int8_matmul(const void* x, const void* q, const void* scale,
                              void* y, void* part, int M, int K, int N,
                              int splits, int x_dtype, int y_dtype,
                              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 16 != 0 || splits <= 0 ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = x_dtype * 2 + y_dtype;
  switch (code) {
    case 0:
      return static_cast<int>(launch_rows<float, float>(
          x, q, scale, y, part, M, K, N, splits, s));
    case 1:
      return static_cast<int>(launch_rows<float, __nv_bfloat16>(
          x, q, scale, y, part, M, K, N, splits, s));
    case 2:
      return static_cast<int>(launch_rows<__nv_bfloat16, float>(
          x, q, scale, y, part, M, K, N, splits, s));
    case 3:
      return static_cast<int>(launch_rows<__nv_bfloat16, __nv_bfloat16>(
          x, q, scale, y, part, M, K, N, splits, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
