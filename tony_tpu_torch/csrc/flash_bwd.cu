// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: the Pallas TPU kernels `_flash_bwd_dq_kernel`
// (tony_tpu/ops/attention.py:378) and `_flash_bwd_dkv_kernel`
// (tony_tpu/ops/attention.py:419), both launched by `_pallas_backward`
// (tony_tpu/ops/attention.py:466), and the group sum `_gqa_reduce`
// (tony_tpu/ops/attention.py:276) that follows the second.
//
// Both kernels recompute the probabilities from the forward's saved
// log-sum-exp, as the TPU kernels do: s = (q . k) * scale (scale applied
// after the product), masked past the diagonal (causal) or past S,
// P = exp(s - lse). With dP = dO . v^T and delta = rowsum(dO * O)
// (computed by the caller, outside the kernels, as on the TPU),
// dS = P * (dP - delta) * scale. Then
//   dQ = sum over keys of dS . k                    (the dq kernel)
//   dV = sum over queries of P^T . dO, dK = dS^T . q (the dkv kernel)
// with every statistic and accumulator in f32 and the results in the input
// dtype. A masked score gives P = 0 exactly (the exponential is not
// evaluated), so a ragged S or a padding row never makes a NaN. The dkv
// kernel folds in the group sum: it writes the narrow dK/dV itself, with
// no atomics and no (B, H, S, D) scratch, so both results are bitwise the
// same from run to run.
//
// What bounds them on this card: operations. Under the causal mask the dq
// kernel does three products of 2 * S^2 * D / 2 per head (q.k, dO.v,
// dS.k), the dkv kernel four (q.k, dO.v, P^T.dO, dS^T.q), against a few
// bytes per element of input: far above the 295 operations per byte at
// which the bf16 tensor cores, not the memory, are the limit. At the
// training shape (B4 H16/8 S4096 D128) that is 4.1e11 and 5.5e11 FLOP:
// 0.42 and 0.56 ms at the H100's dense bf16 989 TFLOP/s.
//
// The dtype picks the kernel, before any launch (nothing is tried and
// abandoned):
// - bfloat16 runs on the tensor cores (`flash_bwd_dq_tc`,
//   `flash_bwd_dkv_tc`), at every head dim the wrappers take (16, 32, 64,
//   128). All seven products are wgmma. Tiles stay bf16, row-major, in
//   swizzled shared memory as TMA writes them (hopper.cuh); the transpose
//   bits of wgmma pick K-major (q.k^T, dO.v^T) or MN-major (P^T.dO, dS.K)
//   reading of the same tile, so nothing is transposed by hand. The score
//   accumulators' registers, turned to bf16, are the A fragments of the
//   following products (as in FlashAttention-3), so P and dS never touch
//   shared memory. The streamed tiles go through a two-stage ring of TMA
//   loads with mbarrier completion; the next tile's copy is issued before
//   the current tile's products. Each block has two warpgroups of 64 rows
//   (keys) over a 128-row resident tile, one block per SM (~128 KB of
//   shared memory at D 128). The one change in arithmetic against the TPU
//   kernels: P and dS are rounded to bf16 before their products (as
//   FlashAttention and cuDNN do); the sums stay f32. The dq kernel sums dP
//   in two halves of D, for the rows whose dP - delta cancels (below).
// - float32 runs on the CUDA cores (`flash_bwd_dq_kernel`,
//   `flash_bwd_dkv_kernel`): tensor cores have no full-f32 product, and TF32
//   would not hold the f32 backward to its 2e-4. 64 x 64 tiles, 8 warps,
//   each 64-key (dq) or 64-query (dkv) tile staged transposed and padded in
//   shared memory; f32 FMA, the accumulators in registers.
//
// Interface: plain C, loaded with ctypes. q, k, v and dO are read through
// their batch, head and sequence strides (the last dimension must be
// contiguous; in bf16 TMA also needs 16-byte aligned bases and strides,
// which the wrappers check); dQ, dK and dV are written through theirs; lse
// and delta are contiguous (B, H, S) f32 arrays. Each function launches on
// the given stream, allocates nothing, and returns cudaGetLastError() after
// the launch (or the tensor-map encoder's refusal).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
// float32: dQ on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
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

  const float* qb = q + b * q_sb + h * q_sh;
  const float* gb = g + b * g_sb + h * g_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = q0 + r;
    const bool live = row < S;
    q_s[i] = live ? qb[row * q_ss + c] : 0.f;
    g_s[i] = live ? gb[row * g_ss + c] : 0.f;
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
      kt_s[c * kTStride + r] = live ? kb[key * k_ss + c] : 0.f;
      vt_s[c * kTStride + r] = live ? vb[key * v_ss + c] : 0.f;
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
    float* o_row = dq + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) o_row[col] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// float32: dK and dV, summed over each GQA group, on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H,
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

  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;
  for (int i = tid; i < kBlockK * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int key = k0 + r;
    const bool live = key < S;
    k_s[i] = live ? kb[key * k_ss + c] : 0.f;
    v_s[i] = live ? vb[key * v_ss + c] : 0.f;
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
    const float* qb = q + b * q_sb + h * q_sh;
    const float* gb = g + b * g_sb + h * g_sh;
    for (int qt = qt_start; qt < n_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the previous tile is consumed; k_s, v_s written
      for (int i = tid; i < kBlockQ * D; i += kThreads) {
        const int r = i / D;
        const int c = i - r * D;
        const int row = q0 + r;
        const bool live = row < S;
        qt_s[c * kTStride + r] = live ? qb[row * q_ss + c] : 0.f;
        gt_s[c * kTStride + r] = live ? gb[row * g_ss + c] : 0.f;
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
    float* dk_row = dk + b * dk_sb + hk * dk_sh + key * dk_ss;
    float* dv_row = dv + b * dv_sb + hk * dv_sh + key * dv_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        dk_row[col] = acc_dk[r][c];
        dv_row[col] = acc_dv[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;   // two consumer warpgroups
constexpr int kTcRows = 128;      // the resident tile: 64 rows per warpgroup
constexpr int kTcStream = 64;     // a streamed tile
constexpr int kStages = 2;        // the streamed tiles' ring
static_assert(kStages == 2, "the loops below alternate two stages");
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcSmem {
  static constexpr int kResident = kTcRows * D * 2;  // bytes of one tile
  static constexpr int kStreamed = kTcStream * D * 2;
  // two resident tiles, a ring of two streamed tiles each, 2 x 2 x 64 f32
  // statistics (dK/dV only), three barriers; 1024 bytes to align the base
  static constexpr int kStats = 2 * kResident + 2 * kStages * kStreamed;
  static constexpr int kBars = kStats + kStages * 2 * kTcStream * 4;
  static constexpr int kBytes = kBars + 3 * 8 + 1024;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// Loads one tile of `rows` rows of head `h`, batch `b` from `row0`, panel
// by panel, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int row0,
                                          int h, int b) {
  using L = hopper::Swizzle<D>;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p) {
    hopper::tma_load_4d(dst + p * rows * L::kRowBytes, map, bar,
                        p * L::kBoxCols, row0, h, b);
  }
}

// acc (64 x 64) = rows [64 wg, 64 wg + 64) of the resident tile `a` times
// the streamed tile `b`, transposed, over the 16-column steps [kk0, kk1)
// of D (wgmma issued, not waited for)
template <int D>
__device__ __forceinline__ void scores(float (&acc)[32], const uint8_t* a,
                                       int wg, const uint8_t* b, int kk0,
                                       int kk1) {
#pragma unroll
  for (int kk = kk0; kk < kk1; ++kk) {
    hopper::wgmma_ss_n64(acc, hopper::desc_k_major<D, kTcRows>(a, 64 * wg, kk),
                         hopper::desc_k_major<D, kTcStream>(b, 0, kk),
                         kk - kk0);
  }
}

// dQ: one block per (b, q-head, 128-row query tile), the longest (latest)
// tiles first; warpgroup w owns rows 64w .. 64w + 63. Q and dO stay
// resident; 64-key K/V tiles stream through a two-stage TMA ring up to the
// diagonal. Per key tile: S = Q.K^T and dP = dO.V^T (wgmma, both operands
// in shared memory), dS = P * (dP - delta) * scale in registers, rounded to
// bf16 as the A fragment of dQ += dS.K (K read MN-major).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S,
                    int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale,
                    int causal) {
  using M = TcSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* g_s = q_s + M::kResident;
  uint8_t* ring = g_s + M::kResident;  // stage s: K at 2s, V at 2s + 1
  uint64_t* bar = reinterpret_cast<uint64_t*>(q_s + M::kBars);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = t % 32;
  const int wg_r0 = q0 + 64 * wg;
  const int kv_end = causal ? min(S, q0 + kTcRows) : S;
  const int n_kt = (kv_end + kTcStream - 1) / kTcStream;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[0], 2 * M::kResident);
    load_tile<D>(q_s, &tm_q, &bar[0], kTcRows, q0, h, b);
    load_tile<D>(g_s, &tm_g, &bar[0], kTcRows, q0, h, b);
    hopper::mbar_expect_tx(&bar[1], 2 * M::kStreamed);
    load_tile<D>(ring, &tm_k, &bar[1], kTcStream, 0, hk, b);
    load_tile<D>(ring + M::kStreamed, &tm_v, &bar[1], kTcStream, 0, hk, b);
  }

  // this thread's two rows of the accumulators: r_lo and r_lo + 8
  const int r_lo = wg_r0 + 16 * (t / 32) + lane / 4;
  float lse2[2], dlt[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r_lo + 8 * j;
    const int64_t at = static_cast<int64_t>(bh) * S + row;
    lse2[j] = row < S ? lse[at] * kLog2e : 0.f;
    dlt[j] = row < S ? delta[at] : 0.f;
  }
  const float scale_log2 = sm_scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const bool rows_live = wg_r0 < S;

  hopper::mbar_wait(&bar[0], 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (tid == 0 && kt + 1 < n_kt) {
      // the other stage was released by the barrier that ended tile kt - 1
      uint8_t* next = ring + (st ^ 1) * 2 * M::kStreamed;
      hopper::mbar_expect_tx(&bar[1 + (st ^ 1)], 2 * M::kStreamed);
      load_tile<D>(next, &tm_k, &bar[1 + (st ^ 1)], kTcStream,
                   (kt + 1) * kTcStream, hk, b);
      load_tile<D>(next + M::kStreamed, &tm_v, &bar[1 + (st ^ 1)], kTcStream,
                   (kt + 1) * kTcStream, hk, b);
    }
    hopper::mbar_wait(&bar[1 + st], (kt >> 1) & 1);
    const uint8_t* k_s = ring + st * 2 * M::kStreamed;
    const uint8_t* v_s = k_s + M::kStreamed;
    const int k0 = kt * kTcStream;
    // causal: a key tile past this warpgroup's last row adds nothing
    if (rows_live && !(causal && k0 > wg_r0 + 63)) {
      // dP in two halves of D, summed after: dS = P * (dP - delta) cancels
      // where one key takes all of a row's weight (row 0 exactly), and one
      // chain of D / 16 tensor-core steps left dP ~7 f32 ulps from delta
      constexpr int kHalf = D > 16 ? D / 32 : 1;
      float s[32], dp[32], dp2[32];
      hopper::wgmma_fence();
      scores<D>(s, q_s, wg, k_s, 0, D / 16);
      scores<D>(dp, g_s, wg, v_s, 0, kHalf);
      if constexpr (D > 16) scores<D>(dp2, g_s, wg, v_s, kHalf, D / 16);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::pin(s);
      hopper::pin(dp);
      if constexpr (D > 16) {
        hopper::pin(dp2);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] += dp2[i];
      }
      // only a tile on the diagonal or the ragged edge is masked
      const bool masked = (causal && k0 + 63 > wg_r0) || k0 + 64 > S ||
                          wg_r0 + 64 > S;
      uint32_t ds[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int j = (i >> 1) & 1;
        const int row = r_lo + 8 * j;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + e;
          const bool live = !masked || (row < S && key < S &&
                                        !(causal && key > row));
          const float p = live
              ? exp2f(fmaf(s[i + e], scale_log2, -lse2[j])) : 0.f;
          v[e] = p * (dp[i + e] - dlt[j]) * sm_scale;
        }
        ds[i / 8][(i % 8) / 2] = hopper::pack_bf16(v[0], v[1]);
      }
      hopper::pin(ds);
      hopper::pin(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        hopper::wgmma_rs<D>(acc, ds[c],
                                  hopper::desc_mn_major<D, kTcStream>(k_s, c));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::pin(acc);
    }
    __syncthreads();  // stage st is consumed by both warpgroups
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = r_lo + 8 * ((i >> 1) & 1);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (row < S) {
      *reinterpret_cast<__nv_bfloat162*>(dq + b * o_sb + h * o_sh +
                                         row * o_ss + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// dK and dV, summed over each GQA group: one block per (b, kv-head,
// 128-key tile), the earliest (longest, under the causal mask) tiles
// first; warpgroup w owns keys 64w .. 64w + 63. K and V stay resident; the
// block walks the group's q-heads and, within each, the 64-row q tiles from
// the diagonal on, streaming Q/dO through a two-stage TMA ring and the
// tile's lse/delta through cp.async. Per q tile: S^T = K.Q^T and dP^T =
// V.dO^T (wgmma, shared memory), P^T and dS^T = P^T * (dP^T - delta) *
// scale in registers, rounded to bf16 as the A fragments of dV += P^T.dO
// and dK += dS^T.Q (dO and Q read MN-major).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dkv_tc(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_g,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Hkv, int S,
                     int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                     int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                     float sm_scale, int causal) {
  using M = TcSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_1024(smem_raw);
  uint8_t* v_s = k_s + M::kResident;
  uint8_t* ring = v_s + M::kResident;  // stage s: Q at 2s, dO at 2s + 1
  // [stage][lse, delta][64]
  float* stats = reinterpret_cast<float*>(k_s + M::kStats);
  uint64_t* bar = reinterpret_cast<uint64_t*>(k_s + M::kBars);

  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.y * kTcRows;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = t % 32;
  const int wg_k0 = k0 + 64 * wg;
  const int n_qt = (S + kTcStream - 1) / kTcStream;
  // causal: query tiles before this key tile contribute nothing
  const int qt_start = causal ? k0 / kTcStream : 0;
  const int per_head = n_qt - qt_start;
  const int n_tiles = rep * per_head;

  // the statistics of tile i (64 lse then 64 delta) into stats[stage]
  // (one value per thread of warpgroup 0)
  auto load_stats = [&](int i, int stage) {
    const int hh = i / per_head;
    const int row = (qt_start + i % per_head) * kTcStream + t % kTcStream;
    const float* src = t < kTcStream ? lse : delta;
    float* dst = stats + stage * 2 * kTcStream + t;
    if (row < S) {
      hopper::cp_async_4(
          dst, src + (static_cast<int64_t>(b) * H + hk * rep + hh) * S + row);
    } else {
      *dst = 0.f;
    }
    hopper::cp_async_commit();
  };
  auto load_q_tile = [&](int i, int stage) {
    const int hh = i / per_head;
    const int q0 = (qt_start + i % per_head) * kTcStream;
    uint8_t* dst = ring + stage * 2 * M::kStreamed;
    hopper::mbar_expect_tx(&bar[1 + stage], 2 * M::kStreamed);
    load_tile<D>(dst, &tm_q, &bar[1 + stage], kTcStream, q0, hk * rep + hh, b);
    load_tile<D>(dst + M::kStreamed, &tm_g, &bar[1 + stage], kTcStream, q0,
                 hk * rep + hh, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[0], 2 * M::kResident);
    load_tile<D>(k_s, &tm_k, &bar[0], kTcRows, k0, hk, b);
    load_tile<D>(v_s, &tm_v, &bar[0], kTcRows, k0, hk, b);
    load_q_tile(0, 0);
  }
  if (wg == 0) load_stats(0, 0);
  hopper::cp_async_wait_all();
  __syncthreads();

  // this thread's two keys of the accumulators: key_lo and key_lo + 8
  const int key_lo = wg_k0 + 16 * (t / 32) + lane / 4;
  const float scale_log2 = sm_scale * kLog2e;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const bool keys_live = wg_k0 < S;

  hopper::mbar_wait(&bar[0], 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      // the other stage was released by the barrier that ended tile it - 1
      if (tid == 0) load_q_tile(it + 1, st ^ 1);
      if (wg == 0) load_stats(it + 1, st ^ 1);
    }
    hopper::mbar_wait(&bar[1 + st], (it >> 1) & 1);
    const uint8_t* q_s = ring + st * 2 * M::kStreamed;
    const uint8_t* g_s = q_s + M::kStreamed;
    const float* lse_s = stats + st * 2 * kTcStream;
    const float* delta_s = lse_s + kTcStream;
    const int q0 = (qt_start + it % per_head) * kTcStream;
    // causal: a q tile before this warpgroup's first key adds nothing
    if (keys_live && !(causal && q0 + 63 < wg_k0)) {
      float s[32], dp[32];
      hopper::wgmma_fence();
      scores<D>(s, k_s, wg, q_s, 0, D / 16);
      scores<D>(dp, v_s, wg, g_s, 0, D / 16);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::pin(s);
      hopper::pin(dp);
      // only a tile on the diagonal or the ragged edge is masked
      const bool masked = (causal && q0 < wg_k0 + 63) || q0 + 64 > S ||
                          wg_k0 + 64 > S;
      uint32_t pf[4][4], dsf[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = key_lo + 8 * ((i >> 1) & 1);
        const int col = 8 * (i / 4) + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
        float p[2], d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = q0 + col + e;
          const bool live = !masked || (row < S && key < S &&
                                        !(causal && key > row));
          const float lse_e = e ? l2.y : l2.x;
          p[e] = live ? exp2f(fmaf(s[i + e], scale_log2, -lse_e * kLog2e))
                      : 0.f;
          d[e] = p[e] * (dp[i + e] - (e ? d2.y : d2.x)) * sm_scale;
        }
        pf[i / 8][(i % 8) / 2] = hopper::pack_bf16(p[0], p[1]);
        dsf[i / 8][(i % 8) / 2] = hopper::pack_bf16(d[0], d[1]);
      }
      hopper::pin(pf);
      hopper::pin(dsf);
      hopper::pin(acc_dv);
      hopper::pin(acc_dk);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        hopper::wgmma_rs<D>(acc_dv, pf[c],
                                  hopper::desc_mn_major<D, kTcStream>(g_s, c));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        hopper::wgmma_rs<D>(acc_dk, dsf[c],
                                  hopper::desc_mn_major<D, kTcStream>(q_s, c));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::pin(acc_dv);
      hopper::pin(acc_dk);
    }
    hopper::cp_async_wait_all();  // tile it + 1's statistics have landed
    __syncthreads();              // stage st is consumed by both warpgroups
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = key_lo + 8 * ((i >> 1) & 1);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (key < S) {
      *reinterpret_cast<__nv_bfloat162*>(dk + b * dk_sb + hk * dk_sh +
                                         key * dk_ss + col) =
          __floats2bfloat162_rn(acc_dk[i], acc_dk[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + b * dv_sb + hk * dv_sh +
                                         key * dv_ss + col) =
          __floats2bfloat162_rn(acc_dv[i], acc_dv[i + 1]);
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

template <int D>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<D>;
  const int smem = DqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kBlockQ - 1) / kBlockQ);
  const long long* st = a.st;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.lse,
      a.delta, static_cast<float*>(a.out0), a.H, a.Hkv, a.S, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12], st[13], st[14], a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<D>;
  const int smem = DkvSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv, (a.S + kBlockK - 1) / kBlockK);
  const long long* st = a.st;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.lse,
      a.delta, static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.H,
      a.Hkv, a.S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16],
      st[17], a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const Args& a) {
  const long long* st = a.st;
  CUtensorMap tq, tg, tk, tv;
  cudaError_t err = hopper::make_map<D>(&tq, a.q, a.S, a.H, a.B, st, kTcRows);
  if (err == cudaSuccess) {
    err = hopper::make_map<D>(&tg, a.g, a.S, a.H, a.B, st + 9, kTcRows);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map<D>(&tk, a.k, a.S, a.Hkv, a.B, st + 3, kTcStream);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map<D>(&tv, a.v, a.S, a.Hkv, a.B, st + 6, kTcStream);
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_tc<D>;
  const int smem = TcSmem<D>::kBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      tq, tg, tk, tv, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.out0),
      a.H, a.Hkv, a.S, st[12], st[13], st[14], a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a) {
  const long long* st = a.st;
  CUtensorMap tq, tg, tk, tv;
  cudaError_t err =
      hopper::make_map<D>(&tq, a.q, a.S, a.H, a.B, st, kTcStream);
  if (err == cudaSuccess) {
    err = hopper::make_map<D>(&tg, a.g, a.S, a.H, a.B, st + 9, kTcStream);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map<D>(&tk, a.k, a.S, a.Hkv, a.B, st + 3, kTcRows);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map<D>(&tv, a.v, a.S, a.Hkv, a.B, st + 6, kTcRows);
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_tc<D>;
  const int smem = TcSmem<D>::kBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // blockIdx.y is the key tile: the early, longest tiles launch first
  const dim3 grid(a.B * a.Hkv, (a.S + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      tq, tg, tk, tv, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.H, a.Hkv, a.S, st[12], st[13],
      st[14], st[15], st[16], st[17], a.sm_scale, a.causal);
  return cudaGetLastError();
}

// float32: the CUDA-core kernels
template <bool kDq>
cudaError_t launch_f32(int D, const Args& a) {
  switch (D) {
    case 16:
      return kDq ? launch_dq<16>(a) : launch_dkv<16>(a);
    case 32:
      return kDq ? launch_dq<32>(a) : launch_dkv<32>(a);
    case 64:
      return kDq ? launch_dq<64>(a) : launch_dkv<64>(a);
    case 128:
      return kDq ? launch_dq<128>(a) : launch_dkv<128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// bfloat16: the tensor-core kernels
template <bool kDq>
cudaError_t launch_bf16(int D, const Args& a) {
  switch (D) {
    case 16:
      return kDq ? launch_dq_tc<16>(a) : launch_dkv_tc<16>(a);
    case 32:
      return kDq ? launch_dq_tc<32>(a) : launch_dkv_tc<32>(a);
    case 64:
      return kDq ? launch_dq_tc<64>(a) : launch_dkv_tc<64>(a);
    case 128:
      return kDq ? launch_dq_tc<128>(a) : launch_dkv_tc<128>(a);
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
      return static_cast<int>(launch_f32<kDq>(D, a));
    case 1:
      return static_cast<int>(launch_bf16<kDq>(D, a));
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
