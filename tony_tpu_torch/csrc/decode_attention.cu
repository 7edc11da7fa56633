// Decode attention for Hopper (sm_90a): K6, a decode step's attention
// sublayer in one launch: RoPE of the new query and key, the write of the
// new key and value row into the layer's cache, and GQA attention of every
// query head over its row's live cache positions.
//
// Replaces: no Pallas kernel. The JAX package's decode step
// (tony_tpu/models/generate.py:194, `decode_step`) rotates q and k with
// `apply_rope` (tony_tpu/ops/rope.py), writes the row with
// `dynamic_update_slice` (generate.py:92) and attends with two masked f32
// einsums over the whole cache (`_cache_attention`, generate.py:120-139),
// which XLA fuses on the TPU. In eager PyTorch the same composition is about
// 50 launches a layer, and the einsums read every slot's whole budget in
// f32 casts (tony_tpu_torch/ops/decode_attention.py holds it as the plain
// version).
//
// Computes, for one layer, every row b of the batch at its own position
// p = pos[b], and every KV head g with its kRep query heads r:
//   q' = T(rope(q[b, g*kRep + r], p)), k' = T(rope(k[b, g], p))
//   (f32 products and sums, one rounding each, as `apply_rope`'s separate
//   elementwise ops; T the cache dtype)
//   kc[b, g, p] = k', vc[b, g, p] = v[b, g]
//   out[b, g*kRep + r] = softmax_j(f32(q') * hd**-0.5 . kc[b, g, j]) vc[b, g]
//   over j in [0, p], in f32, rounded once to T.
// A position outside [0, S) writes nothing, and its rows' outputs are 0.
//
// What bounds it on this card: bytes. Each live cache row of K and V is
// read once (2 * hd * sizeof(T) bytes) and takes 2 * kRep * hd
// multiply-adds: at kRep 4 that is 2 operations a byte, against the ~295
// where the tensor cores become the limit and the ~20 where the CUDA cores
// do. At the 32 slots of budget 3072 of Mistral 7B (Hkv 8, hd 128, bf16) a
// layer's full cache is 403 MB, 120 us at 3.35 TB/s; at a mean length of
// ~1200 the live rows are 159 MB, 48 us.
//
// What the design does about it:
// - Only live rows are read, in the cache's own dtype.
// - A row's live rows are cut into units of `chunk` rows (kUnit = 256, or
//   more where the budget S would make over kMaxParts units), at fixed
//   multiples of chunk: the order of every sum over a row depends on its
//   own length alone, never on the other rows of the batch, so a request
//   decoded among others gives the bits it gives alone (the engine's
//   streams are offline `generate`'s).
// - The units are split evenly over the grid, whatever the lengths (a
//   stream-K form of flash-decoding): the grid is as many blocks as the
//   card holds at once; the units of every (row, KV head) pair, laid end
//   to end, are dealt out in equal contiguous shares. The lengths are read
//   on the card by every block (the host never reads them), so a batch of
//   1 at 4k fills the card as 32 rows at 3k do (16 units a pair).
// - The kRep query heads of a GQA group share one pass over a unit's K and
//   V rows. Each warp streams its rows of the block's units through a ring
//   of kStages stages in shared memory with cp.async (16-byte vectors, past
//   L1, kLoads each for K and V a lane a stage), its loads running ahead
//   across units and pairs; a lane reads back only the slots it filled, so
//   the ring needs no barrier. hd / (16 / sizeof(T)) neighbouring lanes
//   hold one row (hd 128 bf16: 16 lanes, a warp 2 rows, 512 contiguous
//   bytes).
// - Scores are f32 dot products finished across a row's lanes by a
//   reduce-scatter: each lane ends with one head's sum (kRep - 1 +
//   log2(lanes / kRep) shuffles where a butterfly a head takes kRep
//   log2(lanes)). The softmax is online in f32: a running max a head for
//   the warp, the rescale skipped where no max moved; the sums in f32. A
//   unit's warps are merged by their maxima in warp order, then a pair's
//   units in unit order.
// - The block holding the unit with p rotates k, writes k' and v into row
//   p and puts them in row p's ring slots from shared memory: no block
//   loads row p, so no load races the write.
// - A pair's units are folded in the same launch: each unit's block writes
//   its f32 partial (max, sum, output) to the caller's scratch and counts
//   its units of the pair in at the pair's counter (an acquire-release
//   atomic after a barrier, as K5); the block that completes the count
//   folds them, read past L1, and sets the counter back to 0. There are no
//   float atomics: two calls agree bit for bit.
// - T (f32 or bf16), hd (16, 64, 128) and kRep (1, 2, 4, 8) are template
//   parameters; kRep is at most a row's lanes (hd * sizeof(T) / 16).
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, allocates nothing (the caller gives the partials' scratch and the
// zeroed counters), and returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
// stages of a warp's ring: kStages - 1 iterations' loads in flight ahead of
// the one computed
constexpr int kStages = 2;
// the most units one pair spans, the rows of a unit (at least), the most
// rows of one launch (the wrapper launches once a slice of them), and the
// devices a process may use
constexpr int kMaxParts = 32;
constexpr int kUnit = 256;
constexpr int kMaxBatch = 256;
constexpr int kMaxDevices = 64;

// T's scalar conversions, and 16 bytes of T as kN floats
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
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
  // a 32-bit word holds element 2i in its low half, 2i + 1 in its high
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[kN]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// The shape of a warp's work for one instantiation.
template <typename T, int kHd, int kRep>
struct Shape {
  static constexpr int kVec = Elem<T>::kN;             // elements a lane loads
  static constexpr int kRowLanes = kHd / kVec;         // lanes on one row
  static constexpr int kRowsPerLoad = 32 / kRowLanes;  // rows a warp load
  static constexpr int kHeadLanes = kRowLanes / kRep;  // a row's lanes a head
  // 16-byte K (and V) vectors a lane takes a stage
  static constexpr int kLoads = 2;
  static constexpr int kRowsPerIter = kRowsPerLoad * kLoads;
  static constexpr int kStageVecs = kLoads * 32;  // a warp's K (or V) a stage
  // the block's dynamic shared memory: each warp's ring (in uint4s), then
  // each warp's sums over a unit, kRep x kHd floats
  static constexpr int kWarpRing = 2 * kStages * kStageVecs;
  static constexpr int kRingBytes =
      kWarps * (kWarpRing * 16 + kRep * kHd * 4);
  static_assert(kHd % kVec == 0 && kRowLanes <= 32,
                "a row is a whole number of 16-byte vectors, at most 32");
  static_assert(kRep <= kRowLanes, "a lane of a row for each head at least");
};

struct Args {
  const void* q;  // (B, H, 1, hd): q[b, h, d] at b * q_batch + h * hd + d
  const void* k;  // (B, Hkv, 1, hd): k[b, g, d] at b * kv_batch + g * hd + d
  const void* v;  // as k
  int64_t q_batch;
  int64_t kv_batch;
  void* kc;  // the layer's caches (B, Hkv, S, hd), contiguous
  void* vc;
  const float* cos;  // (S, hd / 2) f32
  const float* sin;
  const int64_t* pos;  // (B,)
  void* out;           // (B, H * hd)
  float* part;         // (B * Hkv, kMaxParts, kRep, hd) partial outputs
  float* stats;        // (B * Hkv, kMaxParts, kRep, 2) their max and sum
  int* counters;       // B * Hkv zeros
  int batch;
  int hkv;
  int S;
  float scale;
};

// 16 bytes from device memory into shared memory, past L1 (each byte is
// read once), asynchronously: cp_async_commit closes a group of them and
// cp_async_wait<n> waits until at most n groups are in flight
__device__ __forceinline__ void cp_async16(uint4* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(dst), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The sums over a row's kLanes lanes (the low bits of `lane`) of kN values
// v[0..kN), each lane left with the sum of one: the kN values are halved
// at each of the first log2(kN) steps (a lane whose bit `kLanes / 2` is set
// keeps the upper half and sends its lower half to its partner, which keeps
// the lower), then the one value is summed over the lanes left. Lane bits
// from kLanes / 2 down name the value a lane holds: value
// (lane % kLanes) / (kLanes / kN). kN - 1 + log2(kLanes / kN) shuffles in
// all, against kN log2(kLanes) for a butterfly of each value.
template <int kN, int kLanes>
__device__ __forceinline__ float reduce_scatter(const float (&v)[kN],
                                                int lane) {
  if constexpr (kN == 1) {
    float x = v[0];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      x += __shfl_xor_sync(kFull, x, off);
    }
    return x;
  } else {
    constexpr int kHalf = kN / 2;
    const bool upper = lane & (kLanes / 2);
    float w[kHalf];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[i + kHalf];
      const float keep = upper ? v[i + kHalf] : v[i];
      w[i] = keep + __shfl_xor_sync(kFull, send, kLanes / 2);
    }
    return reduce_scatter<kHalf, kLanes / 2>(w, lane);
  }
}

// x rotated at one table row: (x1 c - x2 s, x1 s + x2 c), each product and
// sum rounded once in f32 (no fused multiply-add), as `apply_rope`'s
// elementwise ops round them, then rounded to T
template <typename T>
__device__ __forceinline__ void rotate(float x1, float x2, float c, float s,
                                       T& o1, T& o2) {
  o1 = Elem<T>::from_f32(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  o2 = Elem<T>::from_f32(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
}

// A block's shared state besides the rings and the warps' sums.
template <typename T, int kHd, int kRep>
struct Shared {
  float q[kRep][kHd];  // the current pair's rotated, scaled q
  alignas(16) T new_k[kHd];  // the current owner unit's new row
  alignas(16) T new_v[kHd];
  // each warp's max and sum over the current unit, its weight in the
  // unit's merge, and each head's max and sum
  float m[kWarps][kRep];
  float l[kWarps][kRep];
  float f[kWarps][kRep];
  float mx[kRep];
  float sum[kRep];
  float w[kMaxParts][kRep];  // the fold's weights
  int units[kMaxBatch + 1];  // one KV head's units of the batch rows before b
  int pos[kMaxBatch];        // each row's position, -1 outside [0, S)
  int last;
};

// A unit: rows [r0, r1) = [k * chunk, min((k + 1) * chunk, p + 1)) of row
// b's live rows [0, p] for KV head g, the k-th of the pair's n_units. The
// units of the batch lie end to end, KV head after KV head: unit u is KV
// head u / per_head's unit u % per_head.
struct Unit {
  int b, g, k, p, n_units, r0, r1;
};

// The launch's units: one KV head's count, their rows, the KV heads.
struct Geo {
  int per_head, chunk, hkv;
};

template <typename T, int kHd, int kRep>
__device__ __forceinline__ Unit unit_at(const Shared<T, kHd, kRep>& sh,
                                        int u, const Geo& geo, int& b) {
  Unit x;
  x.g = u / geo.per_head;
  const int rem = u - x.g * geo.per_head;
  if (rem < sh.units[b]) b = 0;  // a new KV head starts at row 0
  while (sh.units[b + 1] <= rem) ++b;
  x.b = b;
  x.k = rem - sh.units[b];
  x.p = sh.pos[b];
  x.n_units = sh.units[b + 1] - sh.units[b];
  x.r0 = x.k * geo.chunk;
  x.r1 = min(x.r0 + geo.chunk, x.p + 1);
  return x;
}

// A warp's walk over its iterations of the block's units [u, end), in
// order: each unit's rows from r0 + warp * kRowsPerIter, kStride apart;
// units where the warp has no rows are passed over. While u < end, (u, it)
// is an iteration with it < n_iter.
struct Walk {
  int u, end, it, n_iter, first, b;
  Unit x;
};

template <typename T, int kHd, int kRep>
__device__ __forceinline__ void walk_settle(Walk& w,
                                            const Shared<T, kHd, kRep>& sh,
                                            const Geo& geo, int warp) {
  using W = Shape<T, kHd, kRep>;
  constexpr int kStride = kWarps * W::kRowsPerIter;
  while (w.u < w.end && w.it >= w.n_iter) {
    if (w.n_iter >= 0) ++w.u;  // n_iter < 0: u not yet read
    w.it = 0;
    w.n_iter = 0;
    if (w.u < w.end) {
      w.x = unit_at(sh, w.u, geo, w.b);
      w.first = w.x.r0 + warp * W::kRowsPerIter;
      if (w.first < w.x.r1) {
        w.n_iter = (w.x.r1 - w.first + kStride - 1) / kStride;
      }
    }
  }
}

template <typename T, int kHd, int kRep>
__device__ __forceinline__ Walk walk_start(const Shared<T, kHd, kRep>& sh,
                                           int u0, int u1, const Geo& geo,
                                           int warp) {
  Walk w;
  w.u = u0;
  w.end = u1;
  w.it = 0;
  w.n_iter = -1;
  w.first = 0;
  w.b = 0;
  walk_settle(w, sh, geo, warp);
  return w;
}

template <typename T, int kHd, int kRep>
__device__ __forceinline__ void walk_next(Walk& w,
                                          const Shared<T, kHd, kRep>& sh,
                                          const Geo& geo, int warp) {
  ++w.it;
  walk_settle(w, sh, geo, warp);
}

// The block's arrival, with `count` partials, at `pair`'s counter, which
// n_units partials reach in all; the block that completes the count (it
// sets the counter back to 0) folds them. After the barrier, thread 0
// counts the block's partials in with an acquire-release atomic (K5's
// split-K counter): its release orders every thread's partials, written
// before the barrier, before the count; its acquire lets the last block's
// threads, after the second barrier, read what the others wrote.
template <typename T, int kHd, int kRep>
__device__ __forceinline__ bool arrive_last(Shared<T, kHd, kRep>& sh,
                                            int* ctr, int count,
                                            int n_units) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
                 : "=r"(old)
                 : "l"(ctr), "r"(count)
                 : "memory");
    sh.last = old + count == n_units;
    if (sh.last) *ctr = 0;
  }
  __syncthreads();
  return sh.last;
}

// The block that completes `pair`'s count folds its n_units partials in
// unit order: warp 0 turns the units' stats (read once, past L1) into
// weights exp(m_j - max) / sum, a head at a time across its lanes, then
// each output is the weighted sum of its partials.
template <typename T, int kHd, int kRep>
__device__ __forceinline__ void fold_units(const Args& a,
                                           Shared<T, kHd, kRep>& sh,
                                           int pair, int n_units) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* out = static_cast<T*>(a.out) + static_cast<int64_t>(pair) * kRep * kHd;
  const float* __restrict__ parts =
      a.part + static_cast<int64_t>(pair) * kMaxParts * kRep * kHd;
  const float* __restrict__ st =
      a.stats + static_cast<int64_t>(pair) * kMaxParts * kRep * 2;
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      const bool in = lane < n_units;
      const float mj = in ? __ldcg(st + 2 * (lane * kRep + r)) : -INFINITY;
      const float lj = in ? __ldcg(st + 2 * (lane * kRep + r) + 1) : 0.f;
      float mx = mj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float f = exp2f((mj - mx) * kLog2e);
      float sum = lj * f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(kFull, sum, off);
      }
      if (in) sh.w[lane][r] = f / sum;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRep * kHd; i += kThreads) {
    const int r = i / kHd;
    float o = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_units; ++j) {
      o = fmaf(__ldcg(parts + static_cast<int64_t>(j) * kRep * kHd + i),
               sh.w[j][r], o);
    }
    out[i] = Elem<T>::from_f32(o);
  }
}

template <typename T, int kHd, int kRep>
__global__ void __launch_bounds__(kThreads)
    decode_attention(const Args a) {
  using E = Elem<T>;
  using W = Shape<T, kHd, kRep>;
  constexpr int kHalf = kHd / 2;
  constexpr int kStride = kWarps * W::kRowsPerIter;
  __shared__ Shared<T, kHd, kRep> sh;
  extern __shared__ uint4 dyn[];  // the warps' rings, then their sums
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / W::kRowLanes;              // the lane's row of a load
  const int col = (lane % W::kRowLanes) * W::kVec;  // its first element
  // a lane's scores, maxima, sums and probabilities are those of its own
  // head `mine` (reduce_scatter); its sums of p v are every head's
  const int mine = (lane % W::kRowLanes) / W::kHeadLanes;
  const int chunk = max(kUnit, (a.S + kMaxParts - 1) / kMaxParts);

  // every row's position and the prefix of its units (one KV head's), by
  // warp 0: a lane takes `per` neighbouring rows, then a shuffle scan
  if (warp == 0) {
    const int per = (a.batch + 31) / 32;
    int run = 0;
    for (int i = 0; i < per; ++i) {
      const int row = lane * per + i;
      if (row < a.batch) {
        const int64_t p64 = a.pos[row];
        const bool live = p64 >= 0 && p64 < a.S;
        sh.pos[row] = live ? static_cast<int>(p64) : -1;
        run += live ? static_cast<int>(p64) / chunk + 1 : 0;
        sh.units[row + 1] = run;
      }
    }
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    for (int i = 0; i < per; ++i) {
      const int row = lane * per + i;
      if (row < a.batch) sh.units[row + 1] += incl - run;
    }
    if (lane == 0) sh.units[0] = 0;
  }
  __syncthreads();
  if (blockIdx.x == 0) {  // rows outside the cache: outputs 0
    for (int row = 0; row < a.batch; ++row) {
      if (sh.pos[row] >= 0) continue;
      T* out = static_cast<T*>(a.out) +
               static_cast<int64_t>(row) * a.hkv * kRep * kHd;
      for (int i = threadIdx.x; i < a.hkv * kRep * kHd; i += kThreads) {
        out[i] = E::from_f32(0.f);
      }
    }
  }
  // the block's units, an even share of them all
  const int per_head = sh.units[a.batch];
  const int total = per_head * a.hkv;
  const Geo geo{per_head, chunk, a.hkv};
  const int share = (total + gridDim.x - 1) / gridDim.x;
  const int u0 = min(static_cast<int>(blockIdx.x) * share, total);
  const int u1 = min(u0 + share, total);
  if (u0 >= u1) return;

  uint4* kring = dyn + warp * W::kWarpRing + lane;
  uint4* vring = kring + kStages * W::kStageVecs;
  float* sums = reinterpret_cast<float*>(dyn + kWarps * W::kWarpRing);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // the warp's issue walk runs kStages - 1 iterations ahead of its compute
  // walk, across units and pairs; iteration i of the walk is commit group i
  // and ring stage i % kStages. Row p is never loaded: `ready` names the
  // pair whose new row shared memory holds for this warp (set after the
  // barrier that follows its write), and its slots are filled from there
  Walk iw = walk_start(sh, u0, u1, geo, warp);
  int ready = -1;
  auto issue = [&](int gi) {
    if (iw.u < iw.end) {
      const Unit& x = iw.x;
      const int pair = x.b * a.hkv + x.g;
      const int64_t rows_at = static_cast<int64_t>(pair) * a.S * kHd + col;
      const T* kb = static_cast<const T*>(a.kc) + rows_at;
      const T* vb = static_cast<const T*>(a.vc) + rows_at;
      const int base = iw.first + iw.it * kStride;
      uint4* ks = kring + (gi % kStages) * W::kStageVecs;
      uint4* vs = vring + (gi % kStages) * W::kStageVecs;
#pragma unroll
      for (int u = 0; u < W::kLoads; ++u) {
        const int row = base + u * W::kRowsPerLoad + sub;
        if (row < x.p && row < x.r1) {
          cp_async16(ks + u * 32, kb + static_cast<int64_t>(row) * kHd);
          cp_async16(vs + u * 32, vb + static_cast<int64_t>(row) * kHd);
        } else if (row == x.p && row < x.r1) {
          if (ready == pair) {
            ks[u * 32] = *reinterpret_cast<const uint4*>(sh.new_k + col);
            vs[u * 32] = *reinterpret_cast<const uint4*>(sh.new_v + col);
          }
        } else {
          vs[u * 32] = zero;
        }
      }
      walk_next(iw, sh, geo, warp);
    }
    cp_async_commit();
  };
  int gi = 0;
  for (; gi < kStages - 1; ++gi) issue(gi);

  Walk cw = walk_start(sh, u0, u1, geo, warp);
  int ci = 0;
  int b = 0;
  int cur_pair = -1, cur_units = 0, seg = 0;
  float qv[kRep][W::kVec];
  for (int unit = u0; unit < u1; ++unit) {
    const Unit x = unit_at(sh, unit, geo, b);
    const int pair = x.b * a.hkv + x.g;
    const int p = x.p;
    if (pair != cur_pair) {
      if (seg > 0 && arrive_last(sh, a.counters + cur_pair, seg, cur_units)) {
        fold_units(a, sh, cur_pair, cur_units);
      }
      cur_pair = pair;
      cur_units = x.n_units;
      seg = 0;
      // q rotated, rounded to T, then scaled in f32 (as the plain version
      // scales the rounded q)
      const float* cs = a.cos + static_cast<int64_t>(p) * kHalf;
      const float* sn = a.sin + static_cast<int64_t>(p) * kHalf;
      const T* q = static_cast<const T*>(a.q) + x.b * a.q_batch +
                   static_cast<int64_t>(x.g) * kRep * kHd;
      for (int i = threadIdx.x; i < kRep * kHalf; i += kThreads) {
        const int r = i / kHalf;
        const int d = i % kHalf;
        T o1, o2;
        rotate<T>(E::to_f32(q[r * kHd + d]),
                  E::to_f32(q[r * kHd + d + kHalf]), cs[d], sn[d], o1, o2);
        sh.q[r][d] = __fmul_rn(E::to_f32(o1), a.scale);
        sh.q[r][d + kHalf] = __fmul_rn(E::to_f32(o2), a.scale);
      }
    }
    const bool owner = x.k == x.n_units - 1;  // the unit holding row p
    if (owner) {  // k rotated, and row p written
      const float* cs = a.cos + static_cast<int64_t>(p) * kHalf;
      const float* sn = a.sin + static_cast<int64_t>(p) * kHalf;
      const T* kin = static_cast<const T*>(a.k) + x.b * a.kv_batch +
                     static_cast<int64_t>(x.g) * kHd;
      const T* vin = static_cast<const T*>(a.v) + x.b * a.kv_batch +
                     static_cast<int64_t>(x.g) * kHd;
      const int64_t at = (static_cast<int64_t>(pair) * a.S + p) * kHd;
      T* krow = static_cast<T*>(a.kc) + at;
      T* vrow = static_cast<T*>(a.vc) + at;
      for (int d = threadIdx.x; d < kHalf; d += kThreads) {
        T o1, o2;
        rotate<T>(E::to_f32(kin[d]), E::to_f32(kin[d + kHalf]), cs[d],
                  sn[d], o1, o2);
        sh.new_k[d] = o1;
        sh.new_k[d + kHalf] = o2;
        krow[d] = o1;
        krow[d + kHalf] = o2;
      }
      for (int d = threadIdx.x; d < kHd; d += kThreads) {
        sh.new_v[d] = vin[d];
        vrow[d] = vin[d];
      }
    }
    __syncthreads();  // q, the new row; the last unit's merge is done
    if (owner) {
      // row p in the warp's iterations already issued (those of this unit
      // among the next kStages - 1 of its walk)
      Walk fw = cw;
      for (int j = ci; j < gi && fw.u < fw.end; ++j) {
        if (fw.u == unit) {
          const int base = fw.first + fw.it * kStride;
#pragma unroll
          for (int u = 0; u < W::kLoads; ++u) {
            if (base + u * W::kRowsPerLoad + sub == p) {
              kring[(j % kStages) * W::kStageVecs + u * 32] =
                  *reinterpret_cast<const uint4*>(sh.new_k + col);
              vring[(j % kStages) * W::kStageVecs + u * 32] =
                  *reinterpret_cast<const uint4*>(sh.new_v + col);
            }
          }
        }
        walk_next(fw, sh, geo, warp);
      }
      ready = pair;
    }
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
#pragma unroll
      for (int e = 0; e < W::kVec; ++e) qv[r][e] = sh.q[r][col + e];
    }
    float m = -INFINITY, l = 0.f, acc[kRep][W::kVec];
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
#pragma unroll
      for (int e = 0; e < W::kVec; ++e) acc[r][e] = 0.f;
    }
    while (cw.u == unit) {
      issue(gi);
      ++gi;
      cp_async_wait<kStages - 1>();  // group `ci` has landed
      const int base = cw.first + cw.it * kStride;
      const uint4* ks = kring + (ci % kStages) * W::kStageVecs;
      const uint4* vs = vring + (ci % kStages) * W::kStageVecs;
      float s[W::kLoads];
#pragma unroll
      for (int u = 0; u < W::kLoads; ++u) {
        float kf[W::kVec];
        E::unpack(ks[u * 32], kf);
        float dot[kRep];
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          dot[r] = 0.f;
#pragma unroll
          for (int e = 0; e < W::kVec; ++e) {
            dot[r] = fmaf(qv[r][e], kf[e], dot[r]);
          }
        }
        const float d = reduce_scatter<kRep, W::kRowLanes>(dot, lane);
        s[u] = base + u * W::kRowsPerLoad + sub < x.r1 ? d : -INFINITY;
      }
      // the running max of the lane's head over the warp's rows (the row
      // `base` is live, so it is finite); each head's rescale reaches
      // every lane, and is skipped where no head's max moved
      float mt = s[0];
#pragma unroll
      for (int u = 1; u < W::kLoads; ++u) mt = fmaxf(mt, s[u]);
#pragma unroll
      for (int off = W::kRowLanes; off < 32; off <<= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      }
      if (__any_sync(kFull, mt > m)) {
        const float mn = fmaxf(m, mt);
        const float alpha = exp2f((m - mn) * kLog2e);
        m = mn;
        l *= alpha;
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          const float ar = __shfl_sync(kFull, alpha, r * W::kHeadLanes);
#pragma unroll
          for (int e = 0; e < W::kVec; ++e) acc[r][e] *= ar;
        }
      }
#pragma unroll
      for (int u = 0; u < W::kLoads; ++u) {
        float vf[W::kVec];
        E::unpack(vs[u * 32], vf);
        const float pr = exp2f((s[u] - m) * kLog2e);
        l += pr;
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          const float prr = kRep == 1 ? pr
              : __shfl_sync(kFull, pr, sub * W::kRowLanes + r * W::kHeadLanes);
#pragma unroll
          for (int e = 0; e < W::kVec; ++e) {
            acc[r][e] = fmaf(prr, vf[e], acc[r][e]);
          }
        }
      }
      ++ci;
      walk_next(cw, sh, geo, warp);
    }
    // the lanes of one column hold the sums of different rows: add them
#pragma unroll
    for (int off = W::kRowLanes; off < 32; off <<= 1) {
      l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
#pragma unroll
        for (int e = 0; e < W::kVec; ++e) {
          acc[r][e] += __shfl_xor_sync(kFull, acc[r][e], off);
        }
      }
    }
    if (sub == 0) {
      float* mine_sums = sums + warp * kRep * kHd;
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
#pragma unroll
        for (int e = 0; e < W::kVec; ++e) {
          mine_sums[r * kHd + col + e] = acc[r][e];
        }
      }
      if (lane % W::kHeadLanes == 0) {
        sh.m[warp][mine] = m;
        sh.l[warp][mine] = l;
      }
    }
    __syncthreads();
    // the unit's warps merged by their maxima (a warp with no rows holds
    // max -inf and weighs 0; warp 0 always has row r0), in warp order:
    // warp 0 finds each warp's weight a head, then every output is its
    // warps' sums so weighted
    if (warp == 0) {
      for (int i = lane; i < kWarps * kRep; i += 32) {
        const int r = i % kRep;
        float mx = sh.m[0][r];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sh.m[w][r]);
        sh.f[i / kRep][r] = exp2f((sh.m[i / kRep][r] - mx) * kLog2e);
        if (i < kRep) sh.mx[r] = mx;
      }
      __syncwarp();
      for (int r = lane; r < kRep; r += 32) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sum = fmaf(sh.l[w][r], sh.f[w][r], sum);
        }
        sh.sum[r] = sum;
      }
    }
    __syncthreads();
    T* out = static_cast<T*>(a.out) + static_cast<int64_t>(pair) * kRep * kHd;
    const int64_t at = static_cast<int64_t>(pair) * kMaxParts + x.k;
    float* part = a.part + at * kRep * kHd;
    float* stats = a.stats + at * kRep * 2;
    for (int i = threadIdx.x; i < kRep * kHd; i += kThreads) {
      const int r = i / kHd;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        o = fmaf(sums[w * kRep * kHd + i], sh.f[w][r], o);
      }
      if (x.n_units == 1) {
        out[i] = E::from_f32(o / sh.sum[r]);
      } else {
        part[i] = o;
        if (i % kHd == 0) {
          stats[2 * r] = sh.mx[r];
          stats[2 * r + 1] = sh.sum[r];
        }
      }
    }
    if (x.n_units > 1) ++seg;
  }
  cp_async_wait<0>();  // (the groups past the walk's end are empty)
  if (seg > 0 && arrive_last(sh, a.counters + cur_pair, seg, cur_units)) {
    fold_units(a, sh, cur_pair, cur_units);
  }
}

template <typename T, int kHd, int kRep>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (kRep > kHd * static_cast<int>(sizeof(T)) / 16) {
    return cudaErrorInvalidValue;  // fewer lanes on a row than heads
  } else {
    constexpr int kRing = Shape<T, kHd, kRep>::kRingBytes;
    // the ring's size allowed, and the blocks the card holds at once
    // (the grid), found once a device
    static int resident[kMaxDevices] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (resident[device] == 0) {
      err = cudaFuncSetAttribute(decode_attention<T, kHd, kRep>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kRing);
      if (err != cudaSuccess) return err;
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_attention<T, kHd, kRep>, kThreads, kRing);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (err != cudaSuccess) return err;
      resident[device] = (per_sm > 0 ? per_sm : 1) * sms;
    }
    decode_attention<T, kHd, kRep>
        <<<resident[device], kThreads, kRing, stream>>>(a);
    return cudaGetLastError();
  }
}

template <typename T, int kHd>
cudaError_t by_rep(const Args& a, int rep, cudaStream_t stream) {
  switch (rep) {
    case 1: return launch<T, kHd, 1>(a, stream);
    case 2: return launch<T, kHd, 2>(a, stream);
    case 4: return launch<T, kHd, 4>(a, stream);
    case 8: return launch<T, kHd, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_hd(const Args& a, int rep, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return by_rep<T, 16>(a, rep, stream);
    case 64: return by_rep<T, 64>(a, rep, stream);
    case 128: return by_rep<T, 128>(a, rep, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One layer of a decode step (see the note at the top). dtype: 0 = float32,
// 1 = bfloat16, of q, k, v, the caches and out; batch at most 256. part
// holds batch * hkv * 32 * rep * (hd + 2) floats; counters batch * hkv int32
// zeros, left zero by the launch.
extern "C" int tt_decode_attention(
    const void* q, const void* k, const void* v, long long q_batch,
    long long kv_batch, void* kc, void* vc, const void* cos, const void* sin,
    const void* pos, void* out, void* part, void* counters, int batch,
    int hkv, int rep, int S, int hd, float scale, int dtype, void* stream) {
  if (batch <= 0 || batch > kMaxBatch || hkv <= 0 || rep <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_batch = q_batch;
  a.kv_batch = kv_batch;
  a.kc = kc;
  a.vc = vc;
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.pos = static_cast<const int64_t*>(pos);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.stats = a.part + static_cast<int64_t>(batch) * hkv * kMaxParts * rep * hd;
  a.counters = static_cast<int*>(counters);
  a.batch = batch;
  a.hkv = hkv;
  a.S = S;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(by_hd<float>(a, rep, hd, s));
    case 1:
      return static_cast<int>(by_hd<__nv_bfloat16>(a, rep, hd, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
