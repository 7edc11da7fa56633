// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_flash_fwd_kernel`
// (tony_tpu/ops/attention.py:71), launched by `_pallas_forward`
// (tony_tpu/ops/attention.py:220).
//
// Computes, per (batch, query head), softmax(q k^T * scale) v with an online
// softmax over key tiles: the running max m, the running sum l and the output
// accumulator stay in f32, and the (S, S) score matrix never reaches device
// memory. Outputs: `out` in the input dtype and lse = m + log(l) in f32
// (natural log; l clamped at 1e-30, as the TPU kernel does). Grouped-query
// attention reads the narrow K/V directly: query head h uses KV head
// h / (H / Hkv); K and V are never repeated in memory. Causal key tiles past
// the diagonal are never loaded; a sequence length that is not a multiple of
// the tile is masked inside the kernel (keys at or past S score -1e30, query
// rows at or past S are never written), where the TPU path padded to a
// multiple of the block instead.
//
// What bounds it on this card: operations. Two products of 2 * S^2 * D per
// head, halved by the causal mask, against 4 * S * D input bytes per head:
// above a few hundred tokens the arithmetic, not the memory, is the limit.
// At B1 H32/8 S2000 D128 causal that is 3.3e10 FLOP, 0.033 ms at the H100's
// dense bf16 989 TFLOP/s; at the training shape B4 H16/8 S4096, 0.28 ms.
//
// The dtype picks the kernel, before any launch (nothing is tried and
// abandoned):
// - bfloat16 runs on the tensor cores (`flash_fwd_tc`), at every head dim the
//   wrapper takes (16, 32, 64, 128). One block per (b, h, 128-row query
//   tile), the last (longest, under the causal mask) tiles launched first.
//   Two consumer warpgroups own 64 query rows each; the Q tile is loaded
//   once by TMA into swizzled shared memory (the tile convention of
//   hopper.cuh) and stays. A producer warp streams 128-key K and V tiles of
//   the KV head through a two-stage ring of TMA loads with mbarrier
//   completion; it refills a stage as soon as both warpgroups have released
//   it (a second mbarrier per stage), so the copies run ahead of the
//   products and the two warpgroups never wait for each other. Per key tile
//   a warpgroup computes S = Q.K^T (wgmma m64n128, both operands K-major in
//   shared memory), runs the online softmax on the accumulator's registers
//   (the scale applied to S in f32 after the product, exp2 with log2(e)
//   folded into it; the row max and sum reduced across the four threads
//   that share a row), rescales O in registers, and rounds P to bf16 as the
//   A fragments of O += P.V (wgmma, V read MN-major): S and P never touch
//   shared memory. Only the diagonal and ragged tiles are masked. The one
//   change in arithmetic against the TPU kernel, which upcast q, k and v to
//   f32 before both products: q.k takes bf16 operands with f32 sums, and P
//   is rounded to bf16 before P.V, as FlashAttention and cuDNN do; l sums
//   the f32 P. At D 128 a block holds ~161 KB of shared memory (Q 32 KB, two
//   stages of K and V 64 KB each): one block per SM.
// - float32 runs on the CUDA cores (`flash_fwd_kernel`): the tensor cores
//   have no full-f32 product, and TF32 would not hold the f32 forward to its
//   2e-5. One block of 8 warps per (b * h, 64-row query tile); the query
//   tile is loaded once, pre-scaled, into shared memory; each 64-key tile of
//   K (stored transposed, padded against bank conflicts) and V is staged in
//   shared memory and reused by all 64 rows. Each warp owns 8 rows: a lane
//   scores 2 keys for those rows, reading the queries as 16-byte
//   broadcasts; the probabilities go through a per-warp scratch into the
//   P.V product, where a lane owns D/32 output columns, in registers.
//
// Interface: plain C, loaded with ctypes. q, k and v are read through their
// batch, head and sequence strides (the last dimension must be contiguous;
// in bf16 TMA also needs 16-byte aligned bases and strides, which the
// wrapper checks), `out` is written through its strides, and lse is a
// contiguous (B, H, S) f32 array. The function launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the launch
// (or the tensor-map encoder's refusal).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr int kKtStride = kBlockK + 1;  // padded row of the transposed K tile

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
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

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = q0 + r;
    q_s[i] = row < S ? qb[row * q_ss + c] * sm_scale : 0.f;
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
      kt_s[c * kKtStride + r] = live ? kb[key * k_ss + c] : 0.f;
      v_s[i] = live ? vb[key * v_ss + c] : 0.f;
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
    float* o_row = out + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) o_row[col] = acc[r][c] / lr;
    }
    if (lane == 0) lse[static_cast<int64_t>(bh) * S + row] = m[r] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;                 // query rows: 64 per warpgroup
constexpr int kTcKeys = 128;                 // keys of a streamed tile
constexpr int kStages = 2;                   // the K/V ring
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kTcThreads = kConsumers + 32;  // and the producer warp

template <int D>
struct TcSmem {
  static constexpr int kQ = kTcRows * D * 2;     // bytes of the Q tile
  static constexpr int kKv = kTcKeys * D * 2;    // of one K or V tile
  // the Q tile, the ring (stage s: K then V), then the barriers: Q's,
  // full[kStages], empty[kStages]; 1024 bytes to align the base
  static constexpr int kBars = kQ + kStages * 2 * kKv;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// One block per (b, q-head, 128-row query tile), the latest tiles first;
// warpgroup w owns rows 64w .. 64w + 63 and warp 8 is the producer.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int H, int Hkv, int S, int64_t o_sb, int64_t o_sh,
                 int64_t o_ss, float sm_scale, int causal) {
  using M = TcSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align_1024(smem_raw);
  uint8_t* ring = q_s + M::kQ;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(q_s + M::kBars);
  uint64_t* full = bar_q + 1;         // a stage's K and V have landed
  uint64_t* empty = full + kStages;   // every consumer is done with a stage

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;
  const int tid = threadIdx.x;
  // causal: keys past the tile's last query row contribute nothing
  const int kv_end = causal ? min(S, q0 + kTcRows) : S;
  const int n_kt = (kv_end + kTcKeys - 1) / kTcKeys;

  if (tid == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one thread starts every copy; a stage is refilled once
    // its previous tile's empty phase completes
    if (tid == kConsumers) {
      hopper::mbar_expect_tx(bar_q, M::kQ);
      hopper::load_tile<D>(q_s, &tm_q, bar_q, kTcRows, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) {
          hopper::mbar_wait(&empty[st], (kt / kStages - 1) & 1);
        }
        uint8_t* dst = ring + st * 2 * M::kKv;
        hopper::mbar_expect_tx(&full[st], 2 * M::kKv);
        hopper::load_tile<D>(dst, &tm_k, &full[st], kTcKeys, kt * kTcKeys, hk,
                             b);
        hopper::load_tile<D>(dst + M::kKv, &tm_v, &full[st], kTcKeys,
                             kt * kTcKeys, hk, b);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = t % 32;
  const int wg_r0 = q0 + 64 * wg;
  // this thread's two rows of the accumulators: r_lo and r_lo + 8
  const int r_lo = wg_r0 + 16 * (t / 32) + lane / 4;
  const bool rows_live = wg_r0 < S;
  const float scale_log2 = sm_scale * hopper::kLog2e;
  float m[2] = {kNegInf, kNegInf};  // the rows' running max of q.k
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    hopper::mbar_wait(&full[st], (kt / kStages) & 1);
    const uint8_t* k_s = ring + st * 2 * M::kKv;
    const uint8_t* v_s = k_s + M::kKv;
    const int k0 = kt * kTcKeys;
    // causal: a key tile past this warpgroup's last row adds nothing
    if (rows_live && !(causal && k0 > wg_r0 + 63)) {
      float s[kTcKeys / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::wgmma_ss_n128(
            s, hopper::desc_k_major<D, kTcRows>(q_s, 64 * wg, kk),
            hopper::desc_k_major<D, kTcKeys>(k_s, 0, kk), kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::pin(s);
      // only a tile on the diagonal or the ragged edge is masked
      if ((causal && k0 + kTcKeys - 1 > wg_r0) || k0 + kTcKeys > S) {
#pragma unroll
        for (int i = 0; i < kTcKeys / 2; ++i) {
          const int row = r_lo + 8 * ((i >> 1) & 1);
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          if (key >= S || (causal && key > row)) s[i] = kNegInf;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kTcKeys / 2; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float alpha[2], shift[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // the four threads of a row are lanes 4r .. 4r + 3
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        alpha[j] = exp2f((m[j] - mx[j]) * scale_log2);
        m[j] = mx[j];
        shift[j] = mx[j] * scale_log2;
        l[j] *= alpha[j];
      }
      // P = exp(s * scale - m * scale), rounded to bf16 as the A fragments
      // of P.V: k16 step c takes the accumulator's indices 8c .. 8c + 7
      uint32_t pf[kTcKeys / 16][4];
#pragma unroll
      for (int i = 0; i < kTcKeys / 2; i += 2) {
        const int j = (i >> 1) & 1;
        const float p0 = exp2f(fmaf(s[i], scale_log2, -shift[j]));
        const float p1 = exp2f(fmaf(s[i + 1], scale_log2, -shift[j]));
        l[j] += p0 + p1;
        pf[i / 8][(i % 8) / 2] = hopper::pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      hopper::pin(pf);
      hopper::pin(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTcKeys / 16; ++c) {
        hopper::wgmma_rs<D>(acc, pf[c],
                            hopper::desc_mn_major<D, kTcKeys>(v_s, c));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::pin(acc);
    }
    hopper::mbar_arrive(&empty[st]);  // this thread is done with stage st
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    l[j] = fmaxf(l[j], 1e-30f);  // the TPU kernel's clamp
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int j = (i >> 1) & 1;
    const int row = r_lo + 8 * j;
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (row < S) {
      *reinterpret_cast<__nv_bfloat162*>(out + b * o_sb + h * o_sh +
                                         row * o_ss + col) =
          __floats2bfloat162_rn(acc[i] / l[j], acc[i + 1] / l[j]);
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = r_lo + 8 * j;
      if (row < S) {
        lse[static_cast<int64_t>(bh) * S + row] = m[j] * sm_scale + logf(l[j]);
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
  void* out;
  float* lse;
  int B, H, Hkv, S;
  const long long* st;  // q, k, v, out: batch, head and sequence strides
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_f32(const Args& a) {
  auto kernel = flash_fwd_kernel<D>;
  const int smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kBlockQ - 1) / kBlockQ);
  const long long* st = a.st;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.H,
      a.Hkv, a.S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const Args& a) {
  const long long* st = a.st;
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      hopper::make_map<D>(&tq, a.q, a.S, a.H, a.B, st, kTcRows);
  if (err == cudaSuccess) {
    err = hopper::make_map<D>(&tk, a.k, a.S, a.Hkv, a.B, st + 3, kTcKeys);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map<D>(&tv, a.v, a.S, a.Hkv, a.B, st + 6, kTcKeys);
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_tc<D>;
  const int smem = TcSmem<D>::kBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // blockIdx.y counts query tiles from the last: the longest launch first
  const dim3 grid(a.B * a.H, (a.S + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.out), a.lse, a.H, a.Hkv,
      a.S, st[9], st[10], st[11], a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <bool kTc>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 16:
      return kTc ? launch_tc<16>(a) : launch_f32<16>(a);
    case 32:
      return kTc ? launch_tc<32>(a) : launch_f32<32>(a);
    case 64:
      return kTc ? launch_tc<64>(a) : launch_f32<64>(a);
    case 128:
      return kTc ? launch_tc<128>(a) : launch_f32<128>(a);
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
  const Args a{q, k, v, out, static_cast<float*>(lse), B, H, Hkv, S, strides,
               sm_scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<false>(D, a));
    case 1:
      return static_cast<int>(launch_d<true>(D, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
