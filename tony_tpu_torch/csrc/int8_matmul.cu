// W8A16 product for Hopper (sm_90a): K5, the int8-weight decode product,
// for one weight or a batch of them (an MoE layer's expert bank) in one
// launch.
//
// Replaces: XLA's fused int8 dequantize -> dot of the JAX package's int8
// inference path (`dequantize`, tony_tpu/models/quant.py:66-69, called inside
// the decode body at tony_tpu/models/generate.py:161-163), where XLA folds
// the int8 load and the channel-scale multiply into the matmul's operand read
// and the bf16 weight never reaches device memory; and, batched, the expert
// bank einsum "ecd,edf->ecf" on `dequantize_layer`'s banks
// (tony_tpu/models/moe.py:179-182), which XLA runs as one batched dot.
// There is no Pallas kernel behind it; this is how the card does what XLA
// did there.
//
// Computes, for each batch member e, y[m, n] = sum_k x[m, k] * w[k, n], with
//   w[k, n] = q[k, n] * bf16(scale[n])
// exact in f32 (an int8 times an 8-bit significand), the element the JAX
// package's compiled steps multiply by (XLA keeps the bf16 product of its
// `dequantize` unrounded inside a compiled computation), and the sum in
// f32. The scale is common to a column, so it is applied once, to the
// whole sum: y[m, n] = bf16(scale[n]) * sum_k x[m, k] * q[k, n]. x is
// (M, K) f32 or bf16, q a (K, N) int8 slice of a stacked leaf, scale (N,)
// f32, y (M, N) bf16 or f32; a batch member's operands lie at fixed element
// strides from the previous one's.
//
// What bounds it on this card: bytes, in principle. With M <= 16 rows each
// weight byte feeds at most 16 multiply-adds, far below the ~295 operations
// per byte where Hopper's tensor cores become the limit; the least time is
// the int8 weight's K*N bytes (plus x, scale and y) over the memory rate:
// 2.25 ms for the 7.50 G weights of one llama3_8b decode step at 3.35
// TB/s. In practice, at M 4 on the CUDA cores, the instructions come close
// too: 4 multiply-adds and 2 conversion steps per weight byte against the
// card's ~9 issue slots per byte of memory rate.
//
// What the design does about it:
// - Each weight byte is read once, in 16-byte loads along N: a thread owns
//   16 neighbouring columns, and a warp a 512-column tile's row, 512
//   contiguous bytes (four whole lines) at a time.
// - The 8 warps of a block stride over the block's K range as 8 k lanes;
//   the block's x rows over that range are staged once in shared memory (as
//   f32; the caller splits K so that they fit) and read there by
//   broadcast, so the weight loads run with no barrier between them.
// - At most 128 registers a thread for MT <= 4 (two blocks per SM).
// - The int8 to f32 conversion costs a byte permute and an add per element
//   (the int8 is placed in the mantissa of 2^23 and the bias subtracted:
//   exact).
// - Each thread keeps kAhead 16-byte loads in flight: a ring of registers
//   refilled with the load kAhead rows ahead as each row is used. Eight in
//   flight (registers), or a 16-deep cp.async ring in shared memory, were
//   both slower at w_gate M4 (PERF.md §6): the loop is near its issue
//   rate there, not short of bytes in flight.
// - Most products have too few column tiles to fill 132 SMs, so K is split
//   across blocks (`splits`, chosen by the caller's time model); each block
//   writes its f32 partial sums, and the split sums are folded into the
//   same launch: the last block of a group of splits to arrive (an int32
//   counter per tile, counted with an acquire-release atomic after a
//   barrier) adds the group's partial sums in split order, read past L1,
//   and with more than one group the last group's block adds the groups'
//   sums in order. The last arrival sets its counter back to 0, so the
//   counters stay zero between launches with no memset. Counters rather
//   than a cluster: splits run to 64 where a cluster holds 8 (16 at most),
//   and one code path serves every split. Within a block the 8 k lanes are
//   added in order through shared memory. The order of every sum is fixed
//   and there are no float atomics, so two calls agree bit for bit.
// - M is taken MT rows at a time (MT in 1, 2, 4, 8): the accumulators are
//   MT x 16 floats a thread. M > 8 reads the weights once per 8 rows.
//   blockIdx.z covers batch x row blocks, so an expert bank is one launch.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, allocates nothing (the caller gives the split workspace and the
// zeroed counters), and returns cudaGetLastError() after its launch.

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

// One arrival of this block at the counter `ctr`, which `expected` blocks
// reach: true in every thread of the block that arrives last, which also
// sets the counter back to 0. After the barrier, thread 0 counts the block
// in with an acquire-release atomic: its release orders every thread's
// global writes before the barrier (as CUTLASS's split-K semaphore does
// with a fence and a relaxed add), its acquire lets the last block's
// threads, after the second barrier, read what the others wrote.
__device__ __forceinline__ bool arrive_last(int* ctr, int expected) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(ctr)
                 : "memory");
    last = old == expected - 1;
    if (last) *ctr = 0;
  }
  __syncthreads();
  return last;
}

// Where a thread's kOuts outputs of its block's tile lie: output i is
// row m0 + i / 2 of y, column tile0 + tid + (i % 2) * kThreads
// (neighbouring threads on neighbouring columns); and, for a block that
// writes y, their columns' scales, loaded early (load_scale) so that the
// loads overlap the reads of the sums.
template <int kOuts>
struct Outs {
  int64_t at[kOuts];  // (row) * N + column
  bool in[kOuts];     // within M and N
  float sc[kOuts];    // scale[column], as stored (f32)
  int n0;
  __device__ __forceinline__ Outs(int m0, int tile0, int M, int N)
      : n0(tile0 + static_cast<int>(threadIdx.x)) {
#pragma unroll
    for (int i = 0; i < kOuts; ++i) {
      const int m = m0 + i / 2;
      const int n = n0 + (i % 2) * kThreads;
      in[i] = m < M && n < N;
      at[i] = static_cast<int64_t>(m) * N + n;
    }
  }
  __device__ __forceinline__ void load_scale(const float* scale) {
#pragma unroll
    for (int i = 0; i < kOuts; ++i) {
      sc[i] = in[i] ? scale[n0 + (i % 2) * kThreads] : 0.f;
    }
  }
};

// The sums v of a thread's outputs written: to y times the column's
// bf16(scale) (the scale is common to a column, so it is applied once, to
// the whole sum; o.load_scale came first), or with y null to slot as they
// are.
template <int kOuts, typename TY>
__device__ __forceinline__ void put(const Outs<kOuts>& o, const float* v,
                                    TY* y, float* slot) {
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    if (!o.in[i]) continue;
    if (y != nullptr) {
      store(y, o.at[i], v[i] * bf16_round(o.sc[i]));
    } else {
      slot[o.at[i]] = v[i];
    }
  }
}

// A thread's outputs summed over `count` slots of partial sums
// (src + s * stride + at[i], s = 0, 1, ... in order), read past L1 (ld.cg:
// other SMs wrote them), about 32 loads in flight a thread; then put.
template <int kOuts, typename TY>
__device__ __forceinline__ void fold(const Outs<kOuts>& o, const float* src,
                                     int64_t stride, int count, TY* y,
                                     float* slot) {
  constexpr int kU = kOuts >= 32 ? 1 : 32 / kOuts;
  float v[kOuts];
#pragma unroll
  for (int i = 0; i < kOuts; ++i) v[i] = 0.f;
  int s = 0;
  for (; s + kU <= count; s += kU) {
    float t[kU][kOuts];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int i = 0; i < kOuts; ++i) {
        t[u][i] = o.in[i] ? __ldcg(src + (s + u) * stride + o.at[i]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int i = 0; i < kOuts; ++i) v[i] += t[u][i];
    }
  }
  for (; s < count; ++s) {
#pragma unroll
    for (int i = 0; i < kOuts; ++i) {
      v[i] += o.in[i] ? __ldcg(src + s * stride + o.at[i]) : 0.f;
    }
  }
  put(o, v, y, slot);
}

// One block: a 512-column tile (blockIdx.x), a K range of k_chunk rows
// (blockIdx.y of `splits`), MT rows of x of one batch member (blockIdx.z).
// The block's x rows of its K range are staged once, as f32, in dynamic
// shared memory, which then holds the cross-warp sums. With one split the
// result goes straight to y in TY; with more, block (y) writes its f32
// partial sums to part[split][e][m][n] and the split sums are folded in.
template <typename TX, typename TY, int MT>
__global__ void __launch_bounds__(kThreads, MT <= 4 ? 2 : 1)
    w8a16(const TX* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ scale, TY* __restrict__ y,
          float* __restrict__ part, int* __restrict__ counters, int M, int K,
          int N, int k_chunk, int group, int row_blocks, int64_t sx,
          int64_t sq, int64_t ss, int64_t sy) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int cg = tid % kColThreads;
  const int lane_k = tid / kColThreads;
  const int n0 = blockIdx.x * kTileN + cg * 16;
  // blockIdx.z: (batch member e, row block) of batch x row_blocks
  const int e = blockIdx.z / row_blocks;
  const int m0 = (blockIdx.z - e * row_blocks) * MT;
  x += e * sx;
  q += e * sq;
  scale += e * ss;
  y += e * sy;
  const int64_t slab = static_cast<int64_t>(gridDim.z / row_blocks) * M * N;
  if (part != nullptr) part += e * static_cast<int64_t>(M) * N;
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
  // the block's sums: straight to y with one split, else its partial
  // sums to its slot of part
  constexpr int kOuts = MT * kTileN / kThreads;
  Outs<kOuts> o(m0, blockIdx.x * kTileN, M, N);
  if (part == nullptr) o.load_scale(scale);
  float v[kOuts];
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    const int m = i / 2;
    const int c = tid + (i % 2) * kThreads;
    v[i] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v[i] += red[(w * MT + m) * kTileN + c];
  }
  if (part == nullptr) {
    put(o, v, y, static_cast<float*>(nullptr));
    return;
  }
  put(o, v, static_cast<TY*>(nullptr), part + blockIdx.y * slab);

  // the split sums, folded in: the last block of a group of `group`
  // splits to arrive adds the group's partial sums in split order into
  // the group's first slot; the last group to finish adds the groups'
  // sums in order into y. Arrival is counted per (batch and row block,
  // column tile) in int32 counters that the last arrival sets back to 0.
  const int splits = gridDim.y;
  const int groups = (splits + group - 1) / group;
  const int g = blockIdx.y / group;
  const int first = g * group;
  const int members = min(group, splits - first);
  int* ctr = counters + static_cast<int64_t>(blockIdx.z * gridDim.x +
                                             blockIdx.x) * (groups + 1);
  if (!arrive_last(ctr + g, members)) return;
  o.load_scale(scale);
  fold(o, part + first * slab, slab, members,
       groups == 1 ? y : static_cast<TY*>(nullptr), part + first * slab);
  if (groups == 1) return;
  if (!arrive_last(ctr + groups, groups)) return;
  fold(o, part, group * slab, groups, y, static_cast<float*>(nullptr));
}

// the batch of products one launch computes: their count and the element
// strides between one member's x, q, scale and y and the next's
struct Batch {
  int count;
  int64_t sx, sq, ss, sy;
};

template <typename TX, typename TY, int MT>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y,
                   void* part, int* counters, int M, int K, int N, int splits,
                   int group, Batch bt, cudaStream_t stream) {
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
  const int row_blocks = (M + MT - 1) / MT;
  const dim3 grid((N + kTileN - 1) / kTileN, splits, bt.count * row_blocks);
  w8a16<TX, TY, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<TY*>(y),
      splits > 1 ? static_cast<float*>(part) : nullptr, counters, M, K, N,
      k_chunk, group, row_blocks, bt.sx, bt.sq, bt.ss, bt.sy);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_rows(const void* x, const void* q, const void* scale,
                        void* y, void* part, int* counters, int M, int K,
                        int N, int splits, int group, Batch bt,
                        cudaStream_t stream) {
  if (M <= 1) return launch<TX, TY, 1>(x, q, scale, y, part, counters, M, K, N, splits, group, bt, stream);
  if (M <= 2) return launch<TX, TY, 2>(x, q, scale, y, part, counters, M, K, N, splits, group, bt, stream);
  if (M <= 4) return launch<TX, TY, 4>(x, q, scale, y, part, counters, M, K, N, splits, group, bt, stream);
  return launch<TX, TY, 8>(x, q, scale, y, part, counters, M, K, N, splits, group, bt, stream);
}

int rows_per_block(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

}  // namespace

// batch products y_b = x_b . (q_b * bf16(scale_b)), b < batch, the
// operands of b at b times their batch strides (in elements: sx, sq, ss,
// sy) from x, q, scale and y. x_dtype, y_dtype: 0 = float32, 1 =
// bfloat16. Each q_b (K, N) int8 and x, y 16-byte aligned, N % 16 == 0.
// With splits > 1: part holds splits * batch * M * N floats, and counters
// n_counters int32 zeros (left zero by the launch), at least batch * (row
// blocks) * (column tiles) * (groups + 1), groups the number of
// `group`-split groups.
extern "C" int tt_int8_matmul(const void* x, const void* q, const void* scale,
                              void* y, void* part, void* counters,
                              int n_counters, int batch, int M, int K, int N,
                              int splits, int group, long long sx,
                              long long sq, long long ss, long long sy,
                              int x_dtype, int y_dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 16 != 0 || splits <= 0 ||
      batch <= 0 ||
      static_cast<int64_t>(batch) * ((M + rows_per_block(M) - 1) /
                                     rows_per_block(M)) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const int64_t tiles = static_cast<int64_t>((N + kTileN - 1) / kTileN) *
                          ((M + rows_per_block(M) - 1) / rows_per_block(M)) *
                          batch;
    const int groups = group > 0 ? (splits + group - 1) / group : 0;
    if (part == nullptr || counters == nullptr || group <= 0 ||
        tiles * (groups + 1) > n_counters) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int* ctr = static_cast<int*>(counters);
  const Batch bt{batch, sx, sq, ss, sy};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = x_dtype * 2 + y_dtype;
  switch (code) {
    case 0:
      return static_cast<int>(launch_rows<float, float>(
          x, q, scale, y, part, ctr, M, K, N, splits, group, bt, s));
    case 1:
      return static_cast<int>(launch_rows<float, __nv_bfloat16>(
          x, q, scale, y, part, ctr, M, K, N, splits, group, bt, s));
    case 2:
      return static_cast<int>(launch_rows<__nv_bfloat16, float>(
          x, q, scale, y, part, ctr, M, K, N, splits, group, bt, s));
    case 3:
      return static_cast<int>(launch_rows<__nv_bfloat16, __nv_bfloat16>(
          x, q, scale, y, part, ctr, M, K, N, splits, group, bt, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
