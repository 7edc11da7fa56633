// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: the Pallas TPU kernels `_flash_bwd_dq_kernel`
// (tony_tpu/ops/attention.py:378) and `_flash_bwd_dkv_kernel`
// (tony_tpu/ops/attention.py:419), both launched by `_pallas_backward`
// (tony_tpu/ops/attention.py:466), and the group sum `_gqa_reduce`
// (tony_tpu/ops/attention.py:276) that follows the second.
//
// Both kernels recompute the probabilities from the forward's saved
// log-sum-exp, as the TPU kernels do: s = (q . k) * scale, masked to -1e30
// past the diagonal (causal) or past S, P = exp(s - lse). With
// dP = dO . v^T and delta = rowsum(dO * O) (computed by the caller, outside
// the kernels, as on the TPU), dS = P * (dP - delta) * scale. Then
//   dQ = sum over keys of dS . k                    (the dq kernel)
//   dV = sum over queries of P^T . dO, dK = dS^T . q (the dkv kernel)
// with every statistic and accumulator in f32 and the results in the
// input dtype. A masked score gives P = 0 exactly (the exponential is not
// evaluated), so a ragged S or a padding row never makes a NaN.
//
// What bounds them on this card: operations. The dq kernel does three
// products of 2 * S^2 * D / 2 per head under the causal mask (q.k, dO.v,
// dS.k), the dkv kernel four (q.k, dO.v, P^T.dO, dS^T.q), against a few
// bytes per element of input. This first version does that arithmetic in
// f32 on the CUDA cores, as the TPU kernels upcast every block to f32,
// so it runs far below the bf16 tensor-core bound. wgmma, TMA and warp
// specialisation are left to a later change.
//
// What the design does about it (both kernels: 8 warps, 64 x 64 tiles):
// - dq: one block per (b*h, 64-row query tile). The q and dO tiles are
//   loaded once into shared memory; each 64-key tile of K and V is staged
//   once, transposed and padded against bank conflicts, and reused by all
//   64 rows. The key loop stops at the diagonal. Each warp owns 8 query
//   rows; a lane computes the scores and dP of 2 keys for those rows, with
//   the q and dO values read as 16-byte broadcasts. dS goes through a
//   per-warp shared scratch into the dS . K product, where each lane owns
//   D/32 columns of dQ for its warp's 8 rows, in registers.
// - dkv: one block per (b*h_kv, 64-key tile). The block walks the H/Hkv
//   query heads of its group and, for each, the query tiles from the
//   diagonal on, so it writes the narrow dK/dV directly: the group sum is
//   folded in, with no atomics and no (B, H, S, D) scratch. The K and V
//   tiles stay in shared memory; each q and dO tile is staged transposed.
//   Each warp owns 8 keys, a lane the scores of 2 queries for them; P and
//   dS go through per-warp scratch into the two products, where each lane
//   owns D/32 columns of dK and dV for its warp's 8 keys, in registers.
//
// Interface: plain C, loaded with ctypes. q, k, v and dO are read through
// their batch, head and sequence strides (the last dimension must be
// contiguous); dQ, dK and dV are written through theirs; lse and delta are
// contiguous (B, H, S) f32 arrays. Each function launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;     // query rows (dq) or keys (dkv)
constexpr int kTStride = 65;        // padded row of a transposed tile
constexpr float kNegInf = -1e30f;   // the TPU kernels' NEG_INF

static_assert(kBlockQ == kWarps * kRowsPerWarp, "a warp owns 8 rows");
static_assert(kBlockK == kWarps * kRowsPerWarp, "a warp owns 8 keys");

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

__device__ __forceinline__ float dot4(float4 a, const float* b, float acc) {
  acc = fmaf(a.x, b[0], acc);
  acc = fmaf(a.y, b[1], acc);
  acc = fmaf(a.z, b[2], acc);
  return fmaf(a.w, b[3], acc);
}

// Shared-memory layouts, in floats.
template <int D>
struct DqSmem {
  static constexpr int kQ = kBlockQ * D;                    // [64][D]
  static constexpr int kG = kBlockQ * D;                    // [64][D]
  static constexpr int kKt = D * kTStride;                  // [D][65]
  static constexpr int kVt = D * kTStride;                  // [D][65]
  static constexpr int kDs = kWarps * kRowsPerWarp * kBlockK;
  static constexpr int kBytes = 4 * (kQ + kG + kKt + kVt + kDs);
};

template <int D>
struct DkvSmem {
  static constexpr int kK = kBlockK * D;                    // [64][D]
  static constexpr int kV = kBlockK * D;                    // [64][D]
  static constexpr int kQt = D * kTStride;                  // [D][65]
  static constexpr int kGt = D * kTStride;                  // [D][65]
  static constexpr int kP = kWarps * kRowsPerWarp * kBlockQ;
  static constexpr int kDs = kWarps * kRowsPerWarp * kBlockQ;
  static constexpr int kStats = 2 * kBlockQ;                // lse, delta
  static constexpr int kBytes =
      4 * (kK + kV + kQt + kGt + kP + kDs + kStats);
};

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Hkv, int S, int64_t q_sb, int64_t q_sh,
                        int64_t q_ss, int64_t k_sb, int64_t k_sh,
                        int64_t k_ss, int64_t v_sb, int64_t v_sh,
                        int64_t v_ss, int64_t g_sb, int64_t g_sh,
                        int64_t g_ss, int64_t o_sb, int64_t o_sh,
                        int64_t o_ss, float sm_scale, int causal) {
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  constexpr int kCols = (D + 31) / 32;  // dQ columns per lane

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* g_s = q_s + DqSmem<D>::kQ;
  float* kt_s = g_s + DqSmem<D>::kG;
  float* vt_s = kt_s + DqSmem<D>::kKt;
  float* ds_s = vt_s + DqSmem<D>::kVt;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* gb = g + b * g_sb + h * g_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = q0 + r;
    const bool live = row < S;
    q_s[i] = live ? to_f32(qb[row * q_ss + c]) : 0.f;
    g_s[i] = live ? to_f32(gb[row * g_ss + c]) : 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first row
  float lse_r[kRowsPerWarp];
  float delta_r[kRowsPerWarp];
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    const int64_t at = static_cast<int64_t>(bh) * S + row;
    lse_r[r] = row < S ? lse[at] : 0.f;
    delta_r[r] = row < S ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const float* q_w = q_s + warp * kRowsPerWarp * D;
  const float* g_w = g_s + warp * kRowsPerWarp * D;
  float* ds_w = ds_s + warp * kRowsPerWarp * kBlockK;
  // causal: keys past the tile's last query row contribute nothing
  const int kv_end = causal ? min(S, q0 + kBlockQ) : S;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed; q_s, g_s written
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int key = k0 + r;
      const bool live = key < S;
      kt_s[c * kTStride + r] = live ? to_f32(kb[key * k_ss + c]) : 0.f;
      vt_s[c * kTStride + r] = live ? to_f32(vb[key * v_ss + c]) : 0.f;
    }
    __syncthreads();

    // scores and dP of keys k0 + lane and k0 + lane + 32 for the 8 rows
    float s[kRowsPerWarp][2];
    float dp[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r][0] = s[r][1] = 0.f;
      dp[r][0] = dp[r][1] = 0.f;
    }
    for (int d = 0; d < D; d += 4) {
      float ka[4], kc[4], va[4], vc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = kt_s[(d + j) * kTStride + lane];
        kc[j] = kt_s[(d + j) * kTStride + lane + 32];
        va[j] = vt_s[(d + j) * kTStride + lane];
        vc[j] = vt_s[(d + j) * kTStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + r * D + d);
        const float4 gv = *reinterpret_cast<const float4*>(g_w + r * D + d);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kc, s[r][1]);
        dp[r][0] = dot4(gv, va, dp[r][0]);
        dp[r][1] = dot4(gv, vc, dp[r][1]);
      }
    }

    const int key_a = k0 + lane;
    const int key_b = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      const bool live_a = row < S && key_a < S && !(causal && key_a > row);
      const bool live_b = row < S && key_b < S && !(causal && key_b > row);
      const float pa = live_a ? expf(s[r][0] * sm_scale - lse_r[r]) : 0.f;
      const float pb = live_b ? expf(s[r][1] * sm_scale - lse_r[r]) : 0.f;
      ds_w[r * kBlockK + lane] = pa * (dp[r][0] - delta_r[r]) * sm_scale;
      ds_w[r * kBlockK + lane + 32] = pb * (dp[r][1] - delta_r[r]) * sm_scale;
    }
    __syncwarp();

    for (int j = 0; j < kBlockK; ++j) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        kv[c] = col < D ? kt_s[col * kTStride + j] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsv = ds_w[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsv, kv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= S) continue;
    T* o_row = dq + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) o_row[col] = from_f32<T>(acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV, summed over each GQA group
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H,
                         int Hkv, int S, int64_t q_sb, int64_t q_sh,
                         int64_t q_ss, int64_t k_sb, int64_t k_sh,
                         int64_t k_ss, int64_t v_sb, int64_t v_sh,
                         int64_t v_ss, int64_t g_sb, int64_t g_sh,
                         int64_t g_ss, int64_t dk_sb, int64_t dk_sh,
                         int64_t dk_ss, int64_t dv_sb, int64_t dv_sh,
                         int64_t dv_ss, float sm_scale, int causal) {
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  constexpr int kCols = (D + 31) / 32;  // dK/dV columns per lane

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + DkvSmem<D>::kK;
  float* qt_s = v_s + DkvSmem<D>::kV;
  float* gt_s = qt_s + DkvSmem<D>::kQt;
  float* p_s = gt_s + DkvSmem<D>::kGt;
  float* ds_s = p_s + DkvSmem<D>::kP;
  float* lse_s = ds_s + DkvSmem<D>::kDs;
  float* delta_s = lse_s + kBlockQ;

  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  for (int i = tid; i < kBlockK * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int key = k0 + r;
    const bool live = key < S;
    k_s[i] = live ? to_f32(kb[key * k_ss + c]) : 0.f;
    v_s[i] = live ? to_f32(vb[key * v_ss + c]) : 0.f;
  }

  const int key0 = k0 + warp * kRowsPerWarp;  // this warp's first key
  const float* k_w = k_s + warp * kRowsPerWarp * D;
  const float* v_w = v_s + warp * kRowsPerWarp * D;
  float* p_w = p_s + warp * kRowsPerWarp * kBlockQ;
  float* ds_w = ds_s + warp * kRowsPerWarp * kBlockQ;
  float acc_dk[kRowsPerWarp][kCols];
  float acc_dv[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;
  }

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  // causal: query tiles strictly before this key tile contribute nothing
  const int qt_start = causal ? k0 / kBlockQ : 0;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    const T* qb = q + b * q_sb + h * q_sh;
    const T* gb = g + b * g_sb + h * g_sh;
    for (int qt = qt_start; qt < n_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the previous tile is consumed; k_s, v_s written
      for (int i = tid; i < kBlockQ * D; i += kThreads) {
        const int r = i / D;
        const int c = i - r * D;
        const int row = q0 + r;
        const bool live = row < S;
        qt_s[c * kTStride + r] = live ? to_f32(qb[row * q_ss + c]) : 0.f;
        gt_s[c * kTStride + r] = live ? to_f32(gb[row * g_ss + c]) : 0.f;
      }
      if (tid < kBlockQ) {
        const int row = q0 + tid;
        lse_s[tid] = row < S ? lse[bh * S + row] : 0.f;
        delta_s[tid] = row < S ? delta[bh * S + row] : 0.f;
      }
      __syncthreads();

      // scores and dP of queries q0 + lane and q0 + lane + 32 for the 8 keys
      float s[kRowsPerWarp][2];
      float dp[kRowsPerWarp][2];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r][0] = s[r][1] = 0.f;
        dp[r][0] = dp[r][1] = 0.f;
      }
      for (int d = 0; d < D; d += 4) {
        float qa[4], qc[4], ga[4], gc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qa[j] = qt_s[(d + j) * kTStride + lane];
          qc[j] = qt_s[(d + j) * kTStride + lane + 32];
          ga[j] = gt_s[(d + j) * kTStride + lane];
          gc[j] = gt_s[(d + j) * kTStride + lane + 32];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 kv = *reinterpret_cast<const float4*>(k_w + r * D + d);
          const float4 vv = *reinterpret_cast<const float4*>(v_w + r * D + d);
          s[r][0] = dot4(kv, qa, s[r][0]);
          s[r][1] = dot4(kv, qc, s[r][1]);
          dp[r][0] = dot4(vv, ga, dp[r][0]);
          dp[r][1] = dot4(vv, gc, dp[r][1]);
        }
      }

      const int row_a = q0 + lane;
      const int row_b = q0 + lane + 32;
      const float lse_a = lse_s[lane];
      const float lse_b = lse_s[lane + 32];
      const float delta_a = delta_s[lane];
      const float delta_b = delta_s[lane + 32];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int key = key0 + r;
        const bool live_a = key < S && row_a < S && !(causal && key > row_a);
        const bool live_b = key < S && row_b < S && !(causal && key > row_b);
        const float pa = live_a ? expf(s[r][0] * sm_scale - lse_a) : 0.f;
        const float pb = live_b ? expf(s[r][1] * sm_scale - lse_b) : 0.f;
        p_w[r * kBlockQ + lane] = pa;
        p_w[r * kBlockQ + lane + 32] = pb;
        ds_w[r * kBlockQ + lane] = pa * (dp[r][0] - delta_a) * sm_scale;
        ds_w[r * kBlockQ + lane + 32] = pb * (dp[r][1] - delta_b) * sm_scale;
      }
      __syncwarp();

      for (int j = 0; j < kBlockQ; ++j) {
        float gv[kCols];
        float qv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = lane + 32 * c;
          gv[c] = col < D ? gt_s[col * kTStride + j] : 0.f;
          qv[c] = col < D ? qt_s[col * kTStride + j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pv = p_w[r * kBlockQ + j];
          const float dsv = ds_w[r * kBlockQ + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_dv[r][c] = fmaf(pv, gv[c], acc_dv[r][c]);
            acc_dk[r][c] = fmaf(dsv, qv[c], acc_dk[r][c]);
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = key0 + r;
    if (key >= S) continue;
    T* dk_row = dk + b * dk_sb + hk * dk_sh + key * dk_ss;
    T* dv_row = dv + b * dv_sb + hk * dv_sh + key * dv_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        dk_row[col] = from_f32<T>(acc_dk[r][c]);
        dv_row[col] = from_f32<T>(acc_dv[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;
  const float* delta;
  void* out0;  // dQ, or dK
  void* out1;  // dV (dkv only)
  int B, H, Hkv, S;
  const long long* st;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const int smem = DqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kBlockQ - 1) / kBlockQ);
  const long long* st = a.st;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse,
      a.delta, static_cast<T*>(a.out0), a.H, a.Hkv, a.S, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12], st[13], st[14], a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const int smem = DkvSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv, (a.S + kBlockK - 1) / kBlockK);
  const long long* st = a.st;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H,
      a.Hkv, a.S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16],
      st[17], a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 16:
      return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32:
      return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64:
      return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int launch_any(int D, int dtype, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Hkv <= 0 || a.S <= 0 || a.H % a.Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<kDq, float>(D, a));
    case 1:
      return static_cast<int>(launch_d<kDq, __nv_bfloat16>(D, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dO, dq: (B, H, S, D); k, v: (B, Hkv, S, D); each given by its batch,
// head and sequence strides in elements (15 values: q, k, v, dO, dq).
// lse, delta: contiguous (B, H, S) f32. dtype: 0 = float32, 1 = bfloat16.
// D must be 16, 32, 64 or 128 and H a multiple of Hkv.
extern "C" int tt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* g, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int Hkv, int S, int D,
                               const long long* strides, float sm_scale,
                               int causal, int dtype, void* stream) {
  const Args a{q, k, v, g, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, B, H, Hkv, S,
               strides, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return launch_any<true>(D, dtype, a);
}

// As tt_flash_bwd_dq, with dk and dv narrow (B, Hkv, S, D): 18 strides
// (q, k, v, dO, dk, dv).
extern "C" int tt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* g, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int H, int Hkv, int S, int D,
                                const long long* strides, float sm_scale,
                                int causal, int dtype, void* stream) {
  const Args a{q, k, v, g, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, B, H, Hkv, S,
               strides, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return launch_any<false>(D, dtype, a);
}

extern "C" const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
