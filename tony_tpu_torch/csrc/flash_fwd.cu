// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_flash_fwd_kernel`
// (tony_tpu/ops/attention.py:71), launched by `_pallas_forward`
// (tony_tpu/ops/attention.py:220).
//
// Computes, per (batch, query head), softmax(q k^T * scale) v with an online
// softmax over key tiles: the running max m, the running sum l and the output
// accumulator stay in f32, and the (S, S) score matrix never reaches device
// memory. Outputs: `out` in the input dtype and lse = m + log(l) in f32.
// Grouped-query attention reads the narrow K/V directly: query head h uses
// KV head h / (H / Hkv); K and V are never repeated in memory. Causal key
// tiles past the diagonal are skipped; a sequence length that is not a
// multiple of the tile is masked on load (keys at or past S score -1e30,
// query rows at or past S are never written), where the TPU path padded to
// a multiple of the block instead.
//
// What bounds it on this card: operations. Causal attention at S tokens does
// about 2 * S^2 * D multiply-adds per head against 4 * S * D input bytes per
// head, so above a few hundred tokens the arithmetic is the limit. This
// first version does that arithmetic in f32 on the CUDA cores (as the TPU
// kernel upcast every block to f32 before its dots), not on the tensor
// cores, so it runs far below the bf16 bound. wgmma, TMA and warp
// specialisation are left to a later change.
//
// What the design does about it: one block of 8 warps per (b*h, 64-row query
// tile). The query tile is loaded once, pre-scaled, into shared memory; each
// 64-key tile of K (stored transposed, padded against bank conflicts) and V
// is staged once in shared memory and reused by all 64 query rows. Each warp
// owns 8 query rows: a lane computes the scores of 2 keys for those 8 rows,
// reading the query values as 16-byte broadcasts, so one shared-memory load
// feeds 4 to 8 multiply-adds. The probabilities go through a per-warp
// shared-memory scratch into the P.V product, where each lane owns D/32
// output columns of its warp's 8 rows, held in registers.
//
// Interface: plain C, loaded with ctypes. q, k and v are read through their
// strides (the last dimension must be contiguous), `out` is written through
// its strides, and lse is a contiguous (B, H, S) f32 array. The function
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr int kKtStride = kBlockK + 1;  // padded row of the transposed K tile
constexpr float kNegInf = -1e30f;        // the TPU kernel's NEG_INF

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

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Shared-memory layout, in floats.
template <int D>
struct Smem {
  static constexpr int kQ = kBlockQ * D;           // [kBlockQ][D]
  static constexpr int kKt = D * kKtStride;        // [D][kBlockK + 1]
  static constexpr int kV = kBlockK * D;           // [kBlockK][D]
  static constexpr int kP = kWarps * kRowsPerWarp * kBlockK;
  static constexpr int kBytes = 4 * (kQ + kKt + kV + kP);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Hkv, int S,
                     int64_t q_sb, int64_t q_sh, int64_t q_ss,
                     int64_t k_sb, int64_t k_sh, int64_t k_ss,
                     int64_t v_sb, int64_t v_sh, int64_t v_ss,
                     int64_t o_sb, int64_t o_sh, int64_t o_ss,
                     float sm_scale, int causal) {
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  constexpr int kCols = (D + 31) / 32;  // output columns per lane

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* kt_s = q_s + Smem<D>::kQ;
  float* v_s = kt_s + Smem<D>::kKt;
  float* p_s = v_s + Smem<D>::kV;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = q0 + r;
    q_s[i] = row < S ? to_f32(qb[row * q_ss + c]) * sm_scale : 0.f;
  }

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first query row
  const float* q_w = q_s + warp * kRowsPerWarp * D;
  float* p_w = p_s + warp * kRowsPerWarp * kBlockK;
  // causal: keys past the tile's last query row contribute nothing
  const int kv_end = causal ? min(S, q0 + kBlockQ) : S;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed; q_s is written
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int key = k0 + r;
      const bool live = key < S;
      kt_s[c * kKtStride + r] = live ? to_f32(kb[key * k_ss + c]) : 0.f;
      v_s[i] = live ? to_f32(vb[key * v_ss + c]) : 0.f;
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 for the warp's 8 rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float ka[4];
      float kc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = kt_s[(d + j) * kKtStride + lane];
        kc[j] = kt_s[(d + j) * kKtStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + r * D + d);
        s[r][0] = fmaf(qv.x, ka[0], s[r][0]);
        s[r][0] = fmaf(qv.y, ka[1], s[r][0]);
        s[r][0] = fmaf(qv.z, ka[2], s[r][0]);
        s[r][0] = fmaf(qv.w, ka[3], s[r][0]);
        s[r][1] = fmaf(qv.x, kc[0], s[r][1]);
        s[r][1] = fmaf(qv.y, kc[1], s[r][1]);
        s[r][1] = fmaf(qv.z, kc[2], s[r][1]);
        s[r][1] = fmaf(qv.w, kc[3], s[r][1]);
      }
    }

    const int key_a = k0 + lane;
    const int key_b = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      float sa = s[r][0];
      float sb = s[r][1];
      if (key_a >= S || (causal && key_a > row)) sa = kNegInf;
      if (key_b >= S || (causal && key_b > row)) sb = kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float pa = expf(sa - m_new);
      const float pb = expf(sb - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      p_w[r * kBlockK + lane] = pa;
      p_w[r * kBlockK + lane + 32] = pb;
    }
    __syncwarp();

    for (int j = 0; j < kBlockK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < D ? v_s[j * D + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = p_w[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= S) continue;
    const float lr = fmaxf(l[r], 1e-30f);  // the TPU kernel's clamp
    T* o_row = out + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) o_row[col] = from_f32<T>(acc[r][c] / lr);
    }
    if (lane == 0) lse[static_cast<int64_t>(bh) * S + row] = m[r] + logf(lr);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int Hkv, int S,
                   const long long* st, float sm_scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const int smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Hkv, S, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], sm_scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, void* lse, int B, int H, int Hkv, int S,
                     const long long* st, float sm_scale, int causal,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, B, H, Hkv, S, st, sm_scale,
                           causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, H, Hkv, S, st, sm_scale,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, H, Hkv, S, st, sm_scale,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, H, Hkv, S, st, sm_scale,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, S, D), k and v: (B, Hkv, S, D), out: (B, H, S, D), each given by
// its batch, head and sequence strides in elements (12 values: q, k, v,
// out). lse: contiguous (B, H, S) f32. dtype: 0 = float32, 1 = bfloat16.
// D must be 16, 32, 64 or 128 and H a multiple of Hkv.
extern "C" int tt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int H, int Hkv,
                            int S, int D, const long long* strides,
                            float sm_scale, int causal, int dtype,
                            void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<float>(D, q, k, v, out, lse, B, H,
                                              Hkv, S, strides, sm_scale,
                                              causal, s));
    case 1:
      return static_cast<int>(launch_d<__nv_bfloat16>(
          D, q, k, v, out, lse, B, H, Hkv, S, strides, sm_scale, causal, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
