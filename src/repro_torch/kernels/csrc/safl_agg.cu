// SAFL server-channel kernels for Hopper (sm_90a), bound with ctypes
// through a plain C interface (see kernels/build.py and kernels/safl_agg.py).
//
//   safl_fold_f32        o = beta*acc + w*vec over one (D,) f32 row
//                        (replaces src/repro/kernels/safl_agg.py safl_fold)
//   safl_fold_q8         the same fold of one int8 row with its per-block
//                        scales, dequantized on the fly (replaces
//                        safl_agg.py safl_fold_q8)
//   safl_aggregate_f32   K-way weighted reduction of (K, D) f32 rows with
//                        the server step fused: modes fedsgd / avg / mix /
//                        sum, optional (1+tau)^-alpha discount
//                        (replaces safl_agg.py safl_aggregate)
//   safl_aggregate_q8    the same over (K, Dq) int8 rows + (K, Dq/qblock)
//                        scales (replaces safl_agg.py safl_aggregate_q8)
//   sdga_aggregate_f32   the SDGA round in one pass: weighted mean,
//                        momentum, SGD step and EMA anchor, three outputs
//                        (replaces safl_agg.py sdga_aggregate)
//   sdga_aggregate_q8    the same over int8 rows (replaces safl_agg.py
//                        sdga_aggregate_q8)
//   screen_rows_f32      per-row sum of squares of (K, D) f32 rows, the
//                        defense's integrity + norm pass, one launch
//                        (replaces safl_agg.py screen_rows)
//   screen_rows_q8       the same over (K, Dq) int8 rows + scales,
//                        sum_b s_b^2 * sum_{j in b} q_j^2 (replaces
//                        safl_agg.py screen_rows_q8)
//   safl_fold_q4, safl_aggregate_q4, sdga_aggregate_q4, screen_rows_q4
//                        the q8 kernels over packed int4 rows, (K, Dq/2)
//                        bytes of two lanes each (lane 2j the low nibble
//                        of byte j, 2j+1 the high one, two's complement),
//                        unpacked in registers (replace safl_agg.py
//                        safl_fold_q4, safl_aggregate_q4,
//                        sdga_aggregate_q4, screen_rows_q4)
//   safl_fold_topk       the fold of one sparse top-k row: (nk,) int32
//                        coordinates, (nk,) int8 compacted values and
//                        their (nk/qblock,) scales, scattered into the
//                        (d,) bank (replaces safl_agg.py safl_fold_topk)
//   safl_aggregate_topk  the weighted sum of K sparse rows into a zeroed
//                        (d,) output (replaces safl_agg.py
//                        safl_aggregate_topk)
//
// All are pure bandwidth: a handful of flops per element against 1 (int8)
// or 4 (f32) bytes moved per operand.  The design is one coalesced
// streaming pass, each thread owning output lanes in a grid-stride loop
// (the ragged end is masked by the loop bound; nothing is padded), so the
// bytes moved are the bound.  The f32 fold moves 8 bytes a load instead
// (float2), one vector a thread, when its three rows' addresses agree mod
// 8, with the lanes before the output's first 128-byte line and the one
// after the last vector folded alone; else one lane a thread.  The K reduction weights and their
// in-order sum sit in shared memory.  The int8 rows are dequantized in registers as
// (float)q * scale[lane >> qshift] (qblock = 1 << qshift), then weighted,
// as the Pallas bodies do (_dequant_tile): f32 updates never touch memory.
// A packed int4 lane is read the same way from its byte, its nibble
// sign-extended by shifts; a corrupted byte can hold the nibble -8, which
// the quantizer never emits, and it reads as -8.  The quantized folds
// take kFoldQ4Vec = kFoldQ8Vec = 4 lanes a thread over an exact grid
// instead: one load of the vector's bytes (2 bytes of packed int4 lanes,
// a 4-byte word of int8 ones), a float4 load of acc and its scale, all
// issued before any arithmetic, the lanes sign-extended from the word
// (int4: (n ^ 8) - 8 per byte by __vsub4), a float4 store; the lanes
// before the first aligned vector and after the last one go one a thread
// in the same launch, and every lane does where the rows' addresses
// disagree mod a vector.  The q4 K-row aggregate takes kAggQ4Vec = 8
// lanes a thread over an exact grid the same way (aggregate_q4_kernel):
// a vector's p and its first kAggQ4Rows rows' words and scales (one a
// row) loaded first, then the block's K weights computed in parallel
// into shared memory (one barrier), the levels made as floats without a
// conversion instruction, the sum still in row order; lane by lane where
// the rows, p or out are not vector-aligned.  Its parent (thread 0's
// serial weights, then one lane a thread in a grid-stride loop) issued
// its K rows' loads one after another, and spent K conversions a lane.
//
// The screening reductions are bound by the same bytes (one read of the
// rows) but are launch-bound at the engine's K = 1.  They must be
// deterministic and row-independent: a row's sum is bitwise the same
// whether it is screened alone or stacked, and in every launch.  So no
// float atomics: each row is cut into a fixed number of chunks that
// depends on its length only, each chunk reduced by one block in a fixed
// tree into a (K, chunks) scratch, and the row's partials summed in
// index order in a fixed tree (strided per-thread sums, warp shuffles,
// then the warp sums in order), in the same launch: each block bumps an
// integer per-row counter after its partial is written (__threadfence,
// atomicAdd), and the block that arrives last sums the row and resets the
// counter (screen_arrive), so a call is one launch of blocks of 8 warps.
// The f32 screen loads 8 float4 a thread (8,192 lanes a block, 264 blocks
// at the paper CNN's row), in groups of 4 lanes whose partition is
// a function of D only, so the float4 and lane-by-lane loads a row's
// alignment allows give the same sums.  The quantized screens load
// one 16-byte load a lane (4 KB of a q8 row a block), int8 and int4
// squares summed four bytes at a time by __dp4a (exact in int32).  What
// is left above the timer's floor is the row's one read from HBM and the
// last block's two L2 round trips (the counter, then the partials).  NaN
// and Inf propagate: no fast math, no fmaxf, no lane is skipped.

// The top-k kernels scatter instead of streaming: a kept lane j adds
// w * ((float)qv[j] * s[j >> qshift]) to coordinate idx[j] of the bank,
// and lanes with idx outside [0, d) (an empty row's idx == d, pad lanes
// [d, dq) the codec may rank) drop.  The indices of one row are distinct
// (top-k picks each coordinate once; faults never touch them), so one
// row's scatter needs no atomics.  Rows of different uploads do collide,
// and a float sum over three or more of them depends on its order, so
// the K-row sum adds the rows in row order over a zeroed output: the
// chain 0 -> fold(row 0) -> ... -> fold(row K-1) that the streaming
// channel computes.  Bound: the payload (5 bytes a lane + the scales) and
// a read and a write of each kept coordinate of the bank (and the
// output's zeros on the K-row sum); each scattered 4-byte
// read-modify-write moves a whole 32-byte sector.  What sets the time is
// the rate of scattered accesses, not the bytes: on one H100 one launch
// of a row's 215,552 read-modify-writes at ranked (random) coordinates
// takes 0.011 ms with the bank in L2, its gathers alone 0.0069, its
// stores alone 0.0085, the same row at sorted coordinates 0.0074, an
// empty launch 0.005 (kernels/hold_timing.py's probes), and both bounds
// sit under that floor, so each call is one launch:
//
// * the fold (beta == 1 in place, as the engine runs it) takes
//   kTopkFoldVec lanes a thread over an exact grid of kTopkThreads-thread
//   blocks: one load of the vector's idx (4V bytes) and of its qv (V
//   bytes) and the lanes' scale (two where a vector straddles a qblock),
//   all the vector's gathers of acc[idx] in flight before its stores.
//   Lanes whose idx / qv addresses are not vector-aligned (the head up to
//   the first aligned lane, the tail past the last whole vector, or every
//   lane where the two rows disagree mod a vector or qblock < V) go one a
//   thread in the same launch (topk_span).  One lane a thread in blocks
//   of 128 timed fastest: the most warps to wait on the dependent loads
//   (idx, then acc[idx]); 2, 4 and 8 lanes and larger blocks timed
//   slower (csrc/topk_variants.cu, kernels/hold_timing.py);
// * the K-row sum is one cooperative launch of as many blocks as the card
//   holds resident: each thread loads its items of the first
//   kTopkPrefetch rows into registers, writes its share of the zeros,
//   then the rows are scattered in order with a grid-wide barrier
//   (cooperative_groups grid.sync(), which orders memory) before each
//   row; rows past the prefetch load as they go.  Each row's items are
//   cut into one run of whole warps a block, so a row spreads over every
//   SM.  Row 0 adds to the zeros it wrote without reading them back
//   (+0 + v, the same fadd); the later rows gather through L2 (__ldcg:
//   another SM wrote the coordinate in an earlier row), where the 8.6 MB
//   output stays.  A barrier costs 0.0012-0.0023 ms (more blocks, more),
//   under the launch it replaces; kTopkAggVec = 2 lanes a thread in
//   blocks of kTopkAggThreads = 512 timed fastest at the main path's
//   K = 4.

// Floating-point order is part of the contract: every product and sum goes
// through the _rn intrinsics, which nvcc never contracts into an FMA, so
// the kernels round exactly like the plain PyTorch versions beside their
// wrappers (acc + w*v, p - lr*(g/wsum), weights summed k = 0..K-1, the
// SDGA step in the reference's op order).  That keeps the streaming
// channel (a chain of folds, then the step in PyTorch ops) bit-equal to
// the buffered one (one aggregate).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

enum AggMode { kFedsgd = 0, kAvg = 1, kMix = 2, kSum = 3 };

inline int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// Row j, lane i of the f32 (K, stride) buffer.
struct F32Rows {
  const float* u;
  int64_t stride;
  __device__ float operator()(int64_t j, int64_t i) const {
    return u[j * stride + i];
  }
};

// Row j, lane i of the int8 (K, stride) buffer, dequantized with its
// block's scale: (float)q * s (the int8 -> f32 conversion is exact).
struct Q8Rows {
  const int8_t* q;
  const float* s;
  int64_t stride;   // Dq
  int64_t nblocks;  // Dq >> qshift
  int qshift;
  __device__ float operator()(int64_t j, int64_t i) const {
    return __fmul_rn(static_cast<float>(q[j * stride + i]),
                     s[j * nblocks + (i >> qshift)]);
  }
};

// Nibble ``high`` of byte b as a two's complement int4 in [-8, 7]: shift
// it to the top of a 32-bit word, then back with an arithmetic shift.
__device__ __forceinline__ int nibble(uint8_t b, int high) {
  return static_cast<int>(static_cast<uint32_t>(b) << (high ? 24 : 28)) >>
         28;
}

// Row j, lane i of the packed int4 (K, stride) buffer (stride = Dq/2
// bytes), dequantized with its block's scale.
struct Q4Rows {
  const uint8_t* q;
  const float* s;
  int64_t stride;   // Dq / 2
  int64_t nblocks;  // Dq >> qshift
  int qshift;
  __device__ float operator()(int64_t j, int64_t i) const {
    const int v = nibble(q[j * stride + (i >> 1)], static_cast<int>(i & 1));
    return __fmul_rn(static_cast<float>(v), s[j * nblocks + (i >> qshift)]);
  }
};

// Thread 0 writes the K reduction weights (discounted when poly) and their
// sum, taken k = 0..K-1, to shared memory: sw[0..K-1], sw[K].
__device__ void load_weights(const float* w_in, int64_t k, float alpha,
                             int poly, float* sw) {
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int64_t j = 0; j < k; ++j) {
      float wj = w_in[j];
      if (poly) wj = powf(__fadd_rn(1.f, wj), -alpha);
      sw[j] = wj;
      s = __fadd_rn(s, wj);
    }
    sw[k] = s;
  }
  __syncthreads();
}

// sum_j sw[j] * row_j[i], in the fold's order (acc = acc + w*u).
template <class Rows>
__device__ float weighted_sum(const Rows& rows, const float* sw, int64_t k,
                              int64_t i) {
  float acc = 0.f;
  for (int64_t j = 0; j < k; ++j) {
    acc = __fadd_rn(acc, __fmul_rn(sw[j], rows(j, i)));
  }
  return acc;
}

// One lane of the f32 fold: beta*acc + w*vec, rounded as the plain version.
template <bool kUnitBeta>
__device__ __forceinline__ float fold_lane(float a, float v, float w,
                                           float beta) {
  const float wv = __fmul_rn(w, v);
  return kUnitBeta ? __fadd_rn(a, wv) : __fadd_rn(__fmul_rn(beta, a), wv);
}

template <bool kUnitBeta>
__device__ __forceinline__ float2 fold_lane(float2 a, float2 v, float w,
                                            float beta) {
  return make_float2(fold_lane<kUnitBeta>(a.x, v.x, w, beta),
                     fold_lane<kUnitBeta>(a.y, v.y, w, beta));
}

// The f32 fold in vectors of V (float2 or float): thread i folds vector i
// of the lanes from ``head`` on, and lane i of the scalar head and of the
// scalar tail past the last whole vector.  The host picks V and head so
// that ``acc + head``, ``vec + head`` and ``out + head`` are V-aligned.
// acc and out may alias (the in-place fold into a bank row): each lane is
// read and written by the same thread, so neither is __restrict__.
template <bool kUnitBeta, class V>
__global__ void fold_kernel(const float* acc, const float* __restrict__ vec,
                            float* out, float w, float beta, int64_t nv,
                            int64_t head, int64_t tail, int64_t n_tail) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < nv) {
    const V a = reinterpret_cast<const V*>(acc + head)[i];
    const V v = reinterpret_cast<const V*>(vec + head)[i];
    reinterpret_cast<V*>(out + head)[i] = fold_lane<kUnitBeta>(a, v, w, beta);
  }
  if (i < head) out[i] = fold_lane<kUnitBeta>(acc[i], vec[i], w, beta);
  if (i < n_tail) {
    out[tail + i] = fold_lane<kUnitBeta>(acc[tail + i], vec[tail + i], w,
                                         beta);
  }
}

// ---- quantized rows in vectors of V lanes ----
//
// The lanes of a quantized row as a vector kernel reads them: Int8Lanes
// (one int8 lane a byte) or Int4Lanes (two packed lanes a byte, lane 2j
// the low nibble of byte j).  A vector of V lanes is V >> kShift bytes,
// loaded in one aligned load into 32-bit words (load_bytes), then
// sign-extended lane by lane (unpack: the folds, one conversion a lane)
// or made into exact float levels without a conversion (levels: the
// K-row aggregate, K conversions a lane; Int4Lanes only, the one format
// it is built for); lane() reads one lane alone.
struct Int8Lanes {
  static constexpr int kShift = 0;  // log2(lanes a byte)
  template <int V>
  static __device__ __forceinline__ void unpack(const uint32_t* wd,
                                                int (&n)[V]) {
#pragma unroll
    for (int l = 0; l < V; ++l) {
      n[l] = static_cast<int8_t>(wd[l / 4] >> (8 * (l % 4)));
    }
  }
  static __device__ __forceinline__ int lane(const uint8_t* q, int64_t i) {
    return static_cast<int8_t>(q[i]);
  }
};

struct Int4Lanes {
  static constexpr int kShift = 1;
  // a word's 8 nibbles, (n ^ 8) - 8 per byte (__vsub4) of the masked low
  // and high nibbles, so a corrupted -8 nibble reads as -8
  template <int V>
  static __device__ __forceinline__ void unpack(const uint32_t* wd,
                                                int (&n)[V]) {
#pragma unroll
    for (int k = 0; k < (V + 7) / 8; ++k) {
      const uint32_t lo = __vsub4((wd[k] & 0x0F0F0F0Fu) ^ 0x08080808u,
                                  0x08080808u);
      const uint32_t hi = __vsub4(((wd[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                                  0x08080808u);
#pragma unroll
      for (int b = 0; b < 4 && 8 * k + 2 * b < V; ++b) {
        n[8 * k + 2 * b] = static_cast<int8_t>(lo >> (8 * b));
        n[8 * k + 2 * b + 1] = static_cast<int8_t>(hi >> (8 * b));
      }
    }
  }
  static __device__ __forceinline__ int lane(const uint8_t* q, int64_t i) {
    return nibble(q[i >> 1], static_cast<int>(i & 1));
  }
  // The V levels as floats, exactly (float)n without a conversion
  // instruction (I2F runs at 1/8 of the f32 rate on sm_90): a nibble x
  // holds n + 8 as x ^ 8, so the float with the bits 0x4B000000 | (x ^
  // 8) is 2^23 + n + 8, and 2^23 + 8 less it is n (an exact difference).
  // A word's low and high nibbles are masked and XORed a word at a time,
  // then each lane's byte is set under 0x4B by one byte permute.
  template <int V>
  static __device__ __forceinline__ void levels(const uint32_t* wd,
                                                float (&x)[V]) {
#pragma unroll
    for (int k = 0; k < (V + 7) / 8; ++k) {
      const uint32_t lo = (wd[k] & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t hi = ((wd[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int b = 0; b < 4 && 8 * k + 2 * b < V; ++b) {
        // bytes (lo.b, 0, 0, 0x4B) of lo and 0x4B000000
        x[8 * k + 2 * b] = __fsub_rn(
            __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7650u + b)),
            8388616.0f);
        x[8 * k + 2 * b + 1] = __fsub_rn(
            __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7650u + b)),
            8388616.0f);
      }
    }
  }
};

// B = 1, 2, 4, 8 or 16 bytes from a B-aligned p, zero-extended into words.
template <int B>
__device__ __forceinline__ void load_bytes(const uint8_t* p,
                                           uint32_t (&wd)[(B + 3) / 4]) {
  static_assert(B == 1 || B == 2 || B == 4 || B == 8 || B == 16,
                "loads of 1, 2, 4, 8 or 16 bytes");
  if constexpr (B == 1) {
    wd[0] = __ldg(p);
  } else if constexpr (B == 2) {
    wd[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (B == 4) {
    wd[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else if constexpr (B == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    wd[0] = x.x;
    wd[1] = x.y;
  } else {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    wd[0] = x.x;
    wd[1] = x.y;
    wd[2] = x.z;
    wd[3] = x.w;
  }
}

// V = 2 lanes as a float2, V = 4k as k float4, from / to a 4*min(V, 4)-
// byte aligned address.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[V]) {
  if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      x[4 * k] = v.x;
      x[4 * k + 1] = v.y;
      x[4 * k + 2] = v.z;
      x[4 * k + 3] = v.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      reinterpret_cast<float4*>(p)[k] =
          make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
    }
  }
}

// The scales of the V lanes from j0 of a row's scales s: two at most,
// split at the qblock boundary, when qblock >= V; each lane's own below.
template <int V>
__device__ __forceinline__ void vec_scales(const float* __restrict__ s,
                                           int64_t j0, int qshift,
                                           float (&sc)[V]) {
  if ((int64_t{1} << qshift) >= V) {
    const int64_t b0 = j0 >> qshift;
    const int64_t b1 = (j0 + V - 1) >> qshift;
    const float s0 = __ldg(s + b0);
    const float s1 = b1 == b0 ? s0 : __ldg(s + b1);
    const int64_t split = ((b0 + 1) << qshift) - j0;
#pragma unroll
    for (int l = 0; l < V; ++l) sc[l] = l < split ? s0 : s1;
  } else {
#pragma unroll
    for (int l = 0; l < V; ++l) sc[l] = __ldg(s + ((j0 + l) >> qshift));
  }
}

// ---- the quantized folds: V lanes a thread over an exact grid ----
//
// The lanes of one fold of dq lanes: [0, head) one a thread, then nv
// vectors of V lanes from ``head`` (vector v: lanes head + V*v .. + V-1,
// their acc and out in aligned loads of A = min(V, 4) lanes, their
// V >> kShift bytes in one aligned load), then the tail [tail, dq) one a
// thread.  head is the first lane whose byte starts a vector's bytes
// (the row's address plus the lane's bytes a multiple of V >> kShift)
// when acc and out agree mod 4A bytes and acc is then 4A-byte aligned at
// that lane, else dq (every lane alone).  Thread i of the grid takes
// vector i, lane i of the head and lane tail + i.  fold_span<Int4Lanes,
// V> is the q4 fold's partition, fold_span<Int8Lanes, V> the q8 fold's
// (fold_q4_span / fold_q8_span in tests/test_torch_fold_q{4,8}.py).
struct FoldSpan {
  int64_t head, nv, tail;
};

template <class Lanes, int V>
__host__ __device__ __forceinline__ FoldSpan fold_span(const void* acc,
                                                       const void* qp,
                                                       const void* out,
                                                       int64_t dq) {
  constexpr int64_t kA = V < 4 ? V : 4;          // lanes of one acc load
  constexpr int64_t kB = V >> Lanes::kShift;     // bytes of one vector
  const uintptr_t a = reinterpret_cast<uintptr_t>(acc);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const uintptr_t q = reinterpret_cast<uintptr_t>(qp);
  const int64_t h =
      (V - (static_cast<int64_t>(q % kB) << Lanes::kShift)) % V;
  int64_t head = a % 4 == 0 && (a - o) % (4 * kA) == 0 &&
                         (static_cast<int64_t>(a / 4) + h) % kA == 0
                     ? h
                     : dq;
  if (head > dq) head = dq;
  const int64_t nv = (dq - head) / V;
  return FoldSpan{head, nv, head + V * nv};
}

// One lane of a quantized fold from its level and scale: beta*a +
// w*(n*s), in the plain version's rounding.
template <bool kUnitBeta>
__device__ __forceinline__ float fold_quant_lane(float a, int n, float s,
                                                 float w, float beta) {
  return fold_lane<kUnitBeta>(a, __fmul_rn(static_cast<float>(n), s), w,
                              beta);
}

// Thread i's share of a quantized fold over the lanes fold_span lays out,
// V = 2, 4, 8 or 16 lanes a vector: one load of the vector's bytes, V/A
// float2 or float4 loads of acc and the vector's scales, all issued
// before any arithmetic; the lanes sign-extended from the words; V/A
// stores.  acc and out may alias (the in-place fold into a bank row):
// each lane is read and written by one thread, so neither is
// __restrict__.
template <class Lanes, int V, bool kUnitBeta>
__device__ __forceinline__ void fold_quant(const float* acc,
                                           const uint8_t* __restrict__ qp,
                                           const float* __restrict__ s,
                                           float* out, float w, float beta,
                                           const FoldSpan& sp, int64_t dq,
                                           int qshift, int64_t i) {
  static_assert(V == 2 || V == 4 || V == 8 || V == 16,
                "vectors of 2, 4, 8 or 16 lanes");
  constexpr int kB = V >> Lanes::kShift;
  if (i < sp.nv) {
    const int64_t j0 = sp.head + V * i;
    uint32_t wd[(kB + 3) / 4];
    load_bytes<kB>(qp + (j0 >> Lanes::kShift), wd);
    float a[V];
    load_f32<V>(acc + j0, a);
    float sc[V];
    vec_scales<V>(s, j0, qshift, sc);
    int n[V];
    Lanes::template unpack<V>(wd, n);
    float o[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      o[l] = fold_quant_lane<kUnitBeta>(a[l], n[l], sc[l], w, beta);
    }
    store_f32<V>(out + j0, o);
  }
  const int64_t lanes[2] = {i < sp.head ? i : -1,
                            i < dq - sp.tail ? sp.tail + i : -1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int64_t j = lanes[k];
    if (j >= 0) {
      out[j] = fold_quant_lane<kUnitBeta>(acc[j], Lanes::lane(qp, j),
                                          s[j >> qshift], w, beta);
    }
  }
}

// The q4 fold (packed int4 row) and the q8 fold (int8 row): one symbol
// each, one body.
template <int V, int T, bool kUnitBeta>
__global__ void __launch_bounds__(T)
    fold_q4_kernel(const float* acc, const uint8_t* __restrict__ qp,
                   const float* __restrict__ s, float* out, float w,
                   float beta, FoldSpan sp, int64_t dq, int qshift) {
  fold_quant<Int4Lanes, V, kUnitBeta>(
      acc, qp, s, out, w, beta, sp, dq, qshift,
      static_cast<int64_t>(blockIdx.x) * T + threadIdx.x);
}

template <int V, int T, bool kUnitBeta>
__global__ void __launch_bounds__(T)
    fold_q8_kernel(const float* acc, const uint8_t* __restrict__ qp,
                   const float* __restrict__ s, float* out, float w,
                   float beta, FoldSpan sp, int64_t dq, int qshift) {
  fold_quant<Int8Lanes, V, kUnitBeta>(
      acc, qp, s, out, w, beta, sp, dq, qshift,
      static_cast<int64_t>(blockIdx.x) * T + threadIdx.x);
}

// Output lanes [0, n): n = D for fedsgd / mix (p has D lanes), the row
// length for avg / sum.
template <class Rows>
__global__ void aggregate_kernel(Rows rows, const float* __restrict__ w_in,
                                 const float* __restrict__ p,
                                 float* __restrict__ out, int64_t k,
                                 int64_t n, float lr, float alpha, int mode,
                                 int poly) {
  extern __shared__ float sw[];
  load_weights(w_in, k, alpha, poly, sw);
  const float wsum = sw[k];
  const float wsafe = fmaxf(wsum, 1e-12f);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const float acc = weighted_sum(rows, sw, k, i);
    float o;
    switch (mode) {
      case kFedsgd:
        o = __fsub_rn(p[i], __fmul_rn(lr, __fdiv_rn(acc, wsafe)));
        break;
      case kAvg:
        o = __fdiv_rn(acc, wsafe);
        break;
      case kMix:
        o = __fadd_rn(__fmul_rn(__fsub_rn(1.f, wsum), p[i]), acc);
        break;
      default:  // kSum
        o = acc;
    }
    out[i] = o;
  }
}

// ---- the quantized K-row aggregate: V lanes a thread over an exact grid ----
//
// The output lanes [0, n): nv vectors of V lanes from lane 0, then the
// tail [tail, n) one a thread, when every row's bytes of a vector start
// on a V >> kShift-byte boundary (the buffer and its row stride), out
// (and p where the mode reads it) are 4*min(V, 4)-byte aligned and a
// qblock spans a vector (so a vector's lanes share one scale a row);
// else every lane one a thread (nv = tail = 0).  Thread i of the grid
// takes vector i and lane tail + i.
struct AggSpan {
  int64_t nv, tail;
};

template <class Lanes, int V>
AggSpan agg_span(const void* q, int64_t stride, const void* p,
                 const void* out, int64_t n, int qshift) {
  constexpr uintptr_t kB = V >> Lanes::kShift;
  constexpr uintptr_t kAlign = 4 * (V < 4 ? V : 4);
  const bool vec = (int64_t{1} << qshift) >= V &&
                   reinterpret_cast<uintptr_t>(q) % kB == 0 &&
                   static_cast<uintptr_t>(stride) % kB == 0 &&
                   reinterpret_cast<uintptr_t>(out) % kAlign == 0 &&
                   reinterpret_cast<uintptr_t>(p) % kAlign == 0;
  const int64_t nv = vec ? n / V : 0;
  return AggSpan{nv, V * nv};
}

// The mode's step on one lane's weighted sum (p: the lane's param, read
// only by fedsgd / mix), rounded as aggregate_kernel rounds it.
__device__ __forceinline__ float agg_step(int mode, float acc, float p,
                                          float lr, float wsum,
                                          float wsafe) {
  switch (mode) {
    case kFedsgd:
      return __fsub_rn(p, __fmul_rn(lr, __fdiv_rn(acc, wsafe)));
    case kAvg:
      return __fdiv_rn(acc, wsafe);
    case kMix:
      return __fadd_rn(__fmul_rn(__fsub_rn(1.f, wsum), p), acc);
    default:  // kSum
      return acc;
  }
}

// R rows' bytes of one vector (V >> Lanes::kShift bytes each, from qv)
// and their scales (one a row: a qblock spans the vector), in registers:
// loads only, so that a group's loads are in flight together (and the
// first group's across the weights' barrier).
template <class Lanes, int V, int R>
struct RowGroup {
  static constexpr int kB = V >> Lanes::kShift;
  uint32_t wd[R][(kB + 3) / 4];
  float sc[R];

  // rows r0 .. r0+R-1 (those below k): qv and sv at row 0's bytes and
  // scale of the vector
  __device__ __forceinline__ void load(const uint8_t* __restrict__ qv,
                                       const float* __restrict__ sv,
                                       int64_t stride, int64_t nb,
                                       int64_t r0, int64_t k) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t j = r0 + r;
      if (j < k) {
        load_bytes<kB>(qv + j * stride, wd[r]);
        sc[r] = __ldg(sv + j * nb);
      }
    }
  }

  // acc[l] += w_j * (n * s) for the group's rows j = r0 .. in order
  __device__ __forceinline__ void add(float (&acc)[V], const float* sw,
                                      int64_t r0, int64_t k) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t j = r0 + r;
      if (j < k) {
        float x[V];
        Lanes::template levels<V>(wd[r], x);
        const float wj = sw[j];
#pragma unroll
        for (int l = 0; l < V; ++l) {
          acc[l] = __fadd_rn(acc[l], __fmul_rn(wj, __fmul_rn(x[l], sc[r])));
        }
      }
    }
  }
};

// Thread i's share of the K-row aggregate over the quantized rows q
// (row j at q + j*stride bytes, its scales at s + j*nb): a vector's p
// loads and its first R rows' words and scales issued first; then the K
// weights computed in parallel into shared memory sw (thread j takes
// w_j, discounted by powf as load_weights does), one barrier, and each
// thread sums them k = 0..K-1; then the rows in groups of R, each
// group's loads issued before its arithmetic, each lane summed in row
// order (acc + w_j*(n*s), the fold's order, so any K and R give the same
// bits); the mode's step; V/A stores.  sw holds K floats.  Lanes needs
// levels() (the exact float levels of a vector's words).
template <class Lanes, int V, int T, int R>
__device__ __forceinline__ void aggregate_quant(
    const uint8_t* __restrict__ q, const float* __restrict__ s,
    const float* __restrict__ w_in, const float* __restrict__ p,
    float* __restrict__ out, int64_t k, int64_t stride, int64_t nb,
    int qshift, const AggSpan& sp, int64_t n, float lr, float alpha,
    int mode, int poly, float* sw) {
  static_assert(V == 2 || V == 4 || V == 8 || V == 16,
                "vectors of 2, 4, 8 or 16 lanes");
  static_assert(R >= 1, "rows a group");
  const bool with_p = mode == kFedsgd || mode == kMix;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * T + threadIdx.x;
  const bool vec = i < sp.nv;
  const int64_t j0 = V * i;
  const uint8_t* qv = q + (j0 >> Lanes::kShift);
  const float* sv = s + (j0 >> qshift);
  float pv[V];
  RowGroup<Lanes, V, R> rows;
  if (vec) {
    if (with_p) load_f32<V>(p + j0, pv);
    rows.load(qv, sv, stride, nb, 0, k);
  }
  for (int64_t j = threadIdx.x; j < k; j += T) {
    float wj = __ldg(w_in + j);
    if (poly) wj = powf(__fadd_rn(1.f, wj), -alpha);
    sw[j] = wj;
  }
  __syncthreads();
  float wsum = 0.f;
  for (int64_t j = 0; j < k; ++j) wsum = __fadd_rn(wsum, sw[j]);
  const float wsafe = fmaxf(wsum, 1e-12f);
  if (vec) {
    float acc[V];
#pragma unroll
    for (int l = 0; l < V; ++l) acc[l] = 0.f;
    for (int64_t r0 = 0;;) {
      rows.add(acc, sw, r0, k);
      r0 += R;
      if (r0 >= k) break;
      rows.load(qv, sv, stride, nb, r0, k);
    }
    float o[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      o[l] = agg_step(mode, acc[l], with_p ? pv[l] : 0.f, lr, wsum, wsafe);
    }
    store_f32<V>(out + j0, o);
  }
  if (i < n - sp.tail) {
    const int64_t l = sp.tail + i;
    float acc = 0.f;
    for (int64_t j = 0; j < k; ++j) {
      const float u = __fmul_rn(
          static_cast<float>(Lanes::lane(q + j * stride, l)),
          s[j * nb + (l >> qshift)]);
      acc = __fadd_rn(acc, __fmul_rn(sw[j], u));
    }
    out[l] = agg_step(mode, acc, with_p ? p[l] : 0.f, lr, wsum, wsafe);
  }
}

// The q4 K-row aggregate: packed int4 rows of dq/2 bytes.
template <int V, int T, int R>
__global__ void __launch_bounds__(T)
    aggregate_q4_kernel(const uint8_t* __restrict__ q,
                        const float* __restrict__ s,
                        const float* __restrict__ w_in,
                        const float* __restrict__ p,
                        float* __restrict__ out, int64_t k, int64_t dq,
                        int qshift, AggSpan sp, int64_t n, float lr,
                        float alpha, int mode, int poly) {
  extern __shared__ float sw[];
  aggregate_quant<Int4Lanes, V, T, R>(q, s, w_in, p, out, k, dq >> 1,
                                      dq >> qshift, qshift, sp, n, lr, alpha,
                                      mode, poly, sw);
}

// The SDGA round over lanes [0, d), in the reference's op order
// (kernels/ref.py sdga_step_from_mean):
//   g  = (w @ u) / max(sum w, 1e-12)
//   m' = mu*m + g
//   p' = (p - lr*m') + anchor*(e - p)
//   e' = decay*e + omd*p'            (omd = 1 - decay, rounded on the host)
template <class Rows>
__global__ void sdga_kernel(Rows rows, const float* __restrict__ w_in,
                            const float* __restrict__ p,
                            const float* __restrict__ m,
                            const float* __restrict__ e,
                            float* __restrict__ op, float* __restrict__ om,
                            float* __restrict__ oe, int64_t k, int64_t d,
                            float lr, float alpha, float mu, float anchor,
                            float decay, float omd, int poly) {
  extern __shared__ float sw[];
  load_weights(w_in, k, alpha, poly, sw);
  const float wsafe = fmaxf(sw[k], 1e-12f);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < d; i += stride) {
    const float g = __fdiv_rn(weighted_sum(rows, sw, k, i), wsafe);
    const float mn = __fadd_rn(__fmul_rn(mu, m[i]), g);
    const float pi = p[i];
    const float ei = e[i];
    const float pn = __fadd_rn(__fsub_rn(pi, __fmul_rn(lr, mn)),
                               __fmul_rn(anchor, __fsub_rn(ei, pi)));
    op[i] = pn;
    om[i] = mn;
    oe[i] = __fadd_rn(__fmul_rn(decay, ei), __fmul_rn(omd, pn));
  }
}

// ---- defense screening: per-row sum of squares ----

constexpr int kWarps = kThreads / 32;

__device__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;  // lane 0 holds the warp's sum
}

// Thread 0 gets the block's sum of one value per thread: a shuffle tree
// in each warp, then the same tree over the warp sums (padded with 0).
// smem holds kNumWarps floats.
template <int kNumWarps = kWarps>
__device__ float block_sum(float v, float* smem) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) s = warp_sum(lane < kNumWarps ? smem[lane] : 0.f);
  return s;
}

// partials a thread of the last block loads before it sums them
constexpr int kScreenFinishBatch = 8;

// The end of block c of a one-launch screen's row: thread 0's ``t`` is
// the chunk's partial.  It goes to pr[c]; then a __threadfence() and an
// integer atomicAdd on the row's counter *cnt: the block that sees chunks
// - 1 is the row's last, sums the row's partials (read through L2) in
// index order (thread i takes partials i, i + kT, ... loaded
// kScreenFinishBatch at a time, then block_sum), writes *o and sets the
// counter back to 0 for the next launch.  Every thread of the block calls
// it; smem (kW floats) may hold what thread 0 read to form ``t``.
template <int kW>
__device__ void screen_arrive(float t, float* pr, int64_t c, int64_t chunks,
                              int* cnt, float* o, float* smem) {
  constexpr int kT = kW * 32;
  __shared__ int last;
  if (threadIdx.x == 0) {
    pr[c] = t;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(cnt, 1) == chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  float s = 0.f;
  for (int64_t i0 = threadIdx.x; i0 < chunks;
       i0 += int64_t{kT} * kScreenFinishBatch) {
    float v[kScreenFinishBatch];
#pragma unroll
    for (int u = 0; u < kScreenFinishBatch; ++u) {
      const int64_t i = i0 + int64_t{u} * kT;
      v[u] = i < chunks ? __ldcg(pr + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kScreenFinishBatch; ++u) {
      if (i0 + int64_t{u} * kT < chunks) s = __fadd_rn(s, v[u]);
    }
  }
  s = block_sum<kW>(s, smem);
  if (threadIdx.x == 0) {
    *o = s;
    *cnt = 0;
  }
}

// ---- the f32 screen: one launch a call ----
//
// A row's lanes go in groups of 4 (group g: lanes 4g .. 4g+3, the last
// group of a row whose D is not a multiple of 4 short, its missing lanes
// read as 0).  Block (c, row) of a (chunks, K) grid of kW warps takes
// chunk c, the kT * kL groups from c * kT * kL; thread t of it takes the
// kL groups c*kT*kL + j*kT + t, j = 0 .. kL-1 (neighbouring threads on
// neighbouring groups), all loaded before any is summed.  It sums lane e
// of its groups into s_e in j order, then (s_0 + s_1) + (s_2 + s_3);
// block_sum gives the chunk's partial, and screen_arrive the row's sum.
// So the partition and the order are a function of D only: a row's sum
// is bitwise the same alone, stacked (a row of a (K, D) stack with D mod
// 4 = 2 starts 8 bytes off a 16-byte boundary) and in every launch.
//
// kVec: a group as one float4 (every row 16-byte aligned), else lane by
// lane (a row of a stack whose D is not a multiple of 4, or a buffer
// that starts off a boundary).  The two paths load the same lanes into
// the same registers, so they give the same sums bitwise; the lane by
// lane path timed within 1 % of the float4 path at K = 1 on one H100.  No
// float atomics, no fast math, no lane skipped: NaN and Inf propagate.
//
// The package's shape: kW = 8 warps a block, kL = 8 float4 loads a thread
// (8,192 lanes a chunk: 264 blocks at the paper CNN's D, 2 an SM), the
// fastest or within 0.5 % of it at K = 1, K = 4 and on the lane-by-lane
// path among 4, 8 and 16 warps x 2-16 loads on one H100 (K = 1: 0.0097
// ms; 8 x 4 loads, 527 blocks, 4 an SM, 0.0099; 2 loads 0.0102-0.0115;
// csrc/screen_variants.cu, timed by kernels/hold_timing.py).  Keep
// kScreenF32Warps and kScreenF32Loads in step with SCREEN_F32_WARPS and
// SCREEN_F32_LOADS in kernels/safl_agg.py, which size the scratch.
constexpr int kScreenF32Warps = 8;
constexpr int kScreenF32Loads = 8;

template <bool kVec, int kW, int kL>
__global__ void __launch_bounds__(kW * 32)
    screen_f32_kernel(const float* __restrict__ u, float* part,
                      int* __restrict__ count, float* __restrict__ out,
                      int64_t d, int64_t chunks) {
  constexpr int kT = kW * 32;
  __shared__ float smem[kW];
  const int64_t c = blockIdx.x;
  const int64_t row = blockIdx.y;
  const float* r = u + row * d;
  const int64_t g0 = c * (int64_t{kT} * kL) + threadIdx.x;
  float4 v[kL];
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const int64_t i = (g0 + int64_t{j} * kT) * 4;  // the group's first lane
    if (kVec && i + 3 < d) {
      v[j] = __ldg(reinterpret_cast<const float4*>(r + i));
    } else {
      v[j] = make_float4(i < d ? __ldg(r + i) : 0.f,
                         i + 1 < d ? __ldg(r + i + 1) : 0.f,
                         i + 2 < d ? __ldg(r + i + 2) : 0.f,
                         i + 3 < d ? __ldg(r + i + 3) : 0.f);
    }
  }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    s0 = __fadd_rn(s0, __fmul_rn(v[j].x, v[j].x));
    s1 = __fadd_rn(s1, __fmul_rn(v[j].y, v[j].y));
    s2 = __fadd_rn(s2, __fmul_rn(v[j].z, v[j].z));
    s3 = __fadd_rn(s3, __fmul_rn(v[j].w, v[j].w));
  }
  const float s = block_sum<kW>(
      __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3)), smem);
  screen_arrive<kW>(s, part + row * chunks, c, chunks, count + row,
                    out + row, smem);
}

// ---- the quantized screens: one launch a call ----
//
// Block (c, row) of a (chunks, K) grid takes kW warps; warp w takes the
// qpw quantization blocks b0 = (c*kW + w)*qpw .. in order, qpw = kL*512 /
// (bytes per qblock), at least 1 (so a chunk's length depends on the
// row's length and qblock only).  A block's q2_b = sum q^2 is an int32
// sum (exact and order-free: 512 * 128^2 on q8, 512 * 8^2 on the packed
// int4 rows, both below 2^24, so the sum converts to f32 exactly), then
// (q2 * s) * s in f32 as the reference's oracle forms it.  Each warp sums its blocks' terms in block
// order, thread 0 the warps' sums in warp order, into part[row, c], and
// screen_arrive sums the row in its last block.  No float atomics: the
// sum's order is fixed by the row's length.
//
// kVec: 16-byte loads (the row 16-byte aligned, a qblock a multiple of 16
// bytes), kL of them a lane in flight before any is summed; a load's 4
// words are summed by __dp4a (signed int8 x int8 into int32, exact), the
// packed int4 words after sign-extending each nibble in its byte:
// (n ^ 8) - 8 per byte (__vsub4), so a corrupted -8 nibble counts 64.
// Else one byte a lane per load, in the same partition and order (so both
// paths give the same sum bitwise).
//
// The package's shape: kW = 8 warps a block, kL = 1 load a lane (a q8
// qblock a warp): at the paper CNN's row 527 blocks of 256 threads on q8
// (264 on q4), 53 over a top-k upload's values.  More loads a lane (2
// warps of 2: 1,053 blocks, 106 on top-k), fewer warps a block and
// larger blocks all timed slower (csrc/screen_variants.cu, timed by
// kernels/hold_timing.py).  Keep kScreenQWarps and kScreenQLoads in step
// with SCREEN_QWARPS and SCREEN_WARP_BYTES (= kScreenQLoads * 512) in
// kernels/safl_agg.py, which size the scratch.
constexpr int kScreenQWarps = 8;
constexpr int kScreenQLoads = 1;

// Quantization blocks per warp for blocks of bbytes >= 1 bytes when a
// warp covers warp_bytes of the row.
inline int64_t screen_qpw(int64_t bbytes, int64_t warp_bytes) {
  return bbytes >= warp_bytes ? 1 : warp_bytes / bbytes;
}

// sum of squares of the 16 int8 (or 32 packed int4) lanes of v, plus acc
template <bool kPacked>
__device__ __forceinline__ int sumsq16(uint4 v, int acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kPacked) {
      const int lo = static_cast<int>(
          __vsub4((w[i] & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
      const int hi = static_cast<int>(
          __vsub4(((w[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
      acc = __dp4a(lo, lo, acc);
      acc = __dp4a(hi, hi, acc);
    } else {
      const int x = static_cast<int>(w[i]);
      acc = __dp4a(x, x, acc);
    }
  }
  return acc;
}

__device__ __forceinline__ float screen_term(int q2, float sb) {
  return __fmul_rn(__fmul_rn(static_cast<float>(q2), sb), sb);
}

// One warp's sum of the terms of its nq blocks b0 .. b0+nq-1 of the row
// (qr, sr), in block order, in 16-byte loads; bbytes is a multiple of 16,
// so nq <= kL * 32 <= 64.  Every lane returns the sum.  A block spans g = bbytes/16
// lanes' loads: below 32, one load of the warp covers 32/g blocks, each
// reduced by an xor tree over its g lanes; at 32 and above, the warp's
// loads cover one block, summed over g/32 loads.
template <bool kPacked, int kL>
__device__ float warp_terms_vec(const uint8_t* qr, const float* sr,
                                int64_t b0, int nq, int64_t bbytes,
                                int lane) {
  static_assert(kL == 1 || kL == 2, "lanes hold the scales of 64 blocks");
  const int g = static_cast<int>(bbytes >> 4);
  const int gc = g < 32 ? g : 32;  // lanes of one block in one load
  const int per = 32 / gc;         // blocks one load of the warp covers
  const int64_t pieces = static_cast<int64_t>(nq) * g;
  const uint4* src = reinterpret_cast<const uint4*>(qr + b0 * bbytes);
  // the scales first: lane l holds those of blocks l and l + 32
  const float sc0 = lane < nq ? sr[b0 + lane] : 0.f;
  const float sc1 = lane + 32 < nq ? sr[b0 + 32 + lane] : 0.f;
  float acc = 0.f;
  int q2 = 0;
  for (int64_t it0 = 0; it0 * 32 < pieces; it0 += kL) {
    uint4 v[kL];
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const int64_t p = (it0 + j) * 32 + lane;
      v[j] = p < pieces ? __ldg(src + p) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const int64_t it = it0 + j;
      if (it * 32 >= pieces) break;  // uniform across the warp
      int x = sumsq16<kPacked>(v[j], 0);
      for (int off = gc >> 1; off > 0; off >>= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
      }
      q2 += x;
      if (g > 32 && ((it + 1) * 32) % g != 0) continue;  // block not done
      for (int i = 0; i < per; ++i) {
        const int64_t b = g >= 32 ? it * 32 / g : it * per + i;
        if (b >= nq) break;  // uniform
        const int qb = __shfl_sync(0xffffffffu, q2, i * gc);
        const float sb = __shfl_sync(0xffffffffu, b < 32 ? sc0 : sc1,
                                     static_cast<int>(b & 31));
        acc = __fadd_rn(acc, screen_term(qb, sb));
      }
      q2 = 0;
    }
  }
  return acc;
}

// The same sum one byte a lane per load, block by block (lane 0 returns
// it).
template <bool kPacked>
__device__ float warp_terms_bytes(const uint8_t* qr, const float* sr,
                                  int64_t b0, int nq, int64_t bbytes,
                                  int lane) {
  float acc = 0.f;
  for (int j = 0; j < nq; ++j) {
    const int64_t b = b0 + j;
    int q2 = 0;
    for (int64_t i = lane; i < bbytes; i += 32) {
      const uint8_t byte = qr[b * bbytes + i];
      if (kPacked) {
        const int lo = nibble(byte, 0);
        const int hi = nibble(byte, 1);
        q2 += lo * lo + hi * hi;
      } else {
        const int v = static_cast<int8_t>(byte);
        q2 += v * v;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      q2 += __shfl_xor_sync(0xffffffffu, q2, off);
    }
    acc = __fadd_rn(acc, screen_term(q2, sr[b]));
  }
  return acc;
}

template <bool kPacked, bool kVec, int kW, int kL>
__global__ void __launch_bounds__(kW * 32)
    screen_q_kernel(const uint8_t* __restrict__ q,
                    const float* __restrict__ s, float* part,
                    int* __restrict__ count, float* __restrict__ out,
                    int64_t nb, int64_t bbytes, int64_t qpw,
                    int64_t chunks) {
  __shared__ float smem[kW];
  const int64_t c = blockIdx.x;
  const int64_t row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint8_t* qr = q + row * nb * bbytes;
  const float* sr = s + row * nb;
  const int64_t b0 = (c * kW + warp) * qpw;
  const int64_t left = nb - b0;
  const int nq = static_cast<int>(left <= 0 ? 0 : left < qpw ? left : qpw);
  float acc = 0.f;
  if (nq > 0) {
    acc = kVec ? warp_terms_vec<kPacked, kL>(qr, sr, b0, nq, bbytes, lane)
               : warp_terms_bytes<kPacked>(qr, sr, b0, nq, bbytes, lane);
  }
  if (lane == 0) smem[warp] = acc;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kW; ++w) t = __fadd_rn(t, smem[w]);
  }
  screen_arrive<kW>(t, part + row * chunks, c, chunks, count + row,
                    out + row, smem);
}

// ---- top-k sparse wire: scatter of compacted rows ----

// o[i] = beta * a[i] over the dense (d,) row (a and o may alias): the
// fold's decay before the scatter, and the copy of an out-of-place fold.
__global__ void scale_kernel(const float* a, float* o, float beta,
                             int64_t d) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < d; i += stride) {
    o[i] = __fmul_rn(beta, a[i]);
  }
}

// Lanes a thread and threads a block of the top-k fold and of the K-row
// sum, and rows the K-row sum loads before its zeros (the main path's K).
// Keep in step with tests/test_torch_topk_kernels.py, which models the
// lane partition and the phases from these numbers.
constexpr int kTopkFoldVec = 1;
constexpr int kTopkThreads = 128;
constexpr int kTopkAggVec = 2;
constexpr int kTopkAggThreads = 512;
constexpr int kTopkPrefetch = 4;

// The lanes of one sparse row (idx, qv) of nk lanes, for vectors of V:
// lanes [0, head) one a thread, then nv vectors of V (vector v: lanes
// head + V*v .. + V-1, its idx 4V-byte and its qv V-byte aligned), then
// the tail [head + V*nv, nk) one a thread.  head is the lanes up to the
// first aligned one when idx and qv sit at the same lane offset mod V and
// a vector spans at most two qblocks (qblock >= V), else nk (every lane
// alone).  Item it < nv is vector it; item nv + u is lane u of the head
// for u < head, else lane u + V*nv.
struct TopkSpan {
  int64_t head, nv, items;
};

template <int V>
__host__ __device__ __forceinline__ TopkSpan topk_span(const int32_t* idx,
                                                       const int8_t* qv,
                                                       int64_t nk,
                                                       int qshift) {
  const int64_t a =
      static_cast<int64_t>((reinterpret_cast<uintptr_t>(idx) >> 2) % V);
  const int64_t b = static_cast<int64_t>(reinterpret_cast<uintptr_t>(qv) % V);
  int64_t head = a == b && (int64_t{1} << qshift) >= V ? (V - a) % V : nk;
  if (head > nk) head = nk;
  const int64_t nv = (nk - head) / V;
  return TopkSpan{head, nv, nk - (V - 1) * nv};
}

// One item of a sparse row in registers: V coordinates (-1: no lane), the
// V int8 values packed 4 a word, the scales of the first and the last
// lane, and the lanes (from the first) that take the first.
template <int V>
struct TopkItem {
  int32_t i[V];
  uint32_t q[(V + 3) / 4];
  float s0, s1;
  int split;
};

// Item ``it`` of the row (idx, qv, s) laid out by ``sp``.  Loads only: no
// value is used here, so the loads of several items stay in flight.
template <int V>
__device__ __forceinline__ TopkItem<V> load_topk_item(
    const int32_t* __restrict__ idx, const int8_t* __restrict__ qv,
    const float* __restrict__ s, const TopkSpan& sp, int64_t it,
    int qshift) {
  TopkItem<V> x;
  if (it < sp.nv) {
    const int64_t j0 = sp.head + V * it;
    if constexpr (V == 1) {
      x.i[0] = __ldg(idx + j0);
      x.q[0] = static_cast<uint8_t>(__ldg(qv + j0));
    } else if constexpr (V == 2) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(idx + j0));
      x.i[0] = v.x;
      x.i[1] = v.y;
      x.q[0] = static_cast<uint16_t>(
          __ldg(reinterpret_cast<const short*>(qv + j0)));
    } else if constexpr (V == 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(idx + j0));
      x.i[0] = v.x;
      x.i[1] = v.y;
      x.i[2] = v.z;
      x.i[3] = v.w;
      x.q[0] = static_cast<uint32_t>(
          __ldg(reinterpret_cast<const int*>(qv + j0)));
    } else {
      static_assert(V == 8, "vectors of 1, 2, 4 or 8 lanes");
      const int4 v0 = __ldg(reinterpret_cast<const int4*>(idx + j0));
      const int4 v1 = __ldg(reinterpret_cast<const int4*>(idx + j0 + 4));
      x.i[0] = v0.x;
      x.i[1] = v0.y;
      x.i[2] = v0.z;
      x.i[3] = v0.w;
      x.i[4] = v1.x;
      x.i[5] = v1.y;
      x.i[6] = v1.z;
      x.i[7] = v1.w;
      const int2 w = __ldg(reinterpret_cast<const int2*>(qv + j0));
      x.q[0] = static_cast<uint32_t>(w.x);
      x.q[1] = static_cast<uint32_t>(w.y);
    }
    const int64_t b0 = j0 >> qshift;
    const int64_t b1 = (j0 + V - 1) >> qshift;
    x.s0 = __ldg(s + b0);
    x.s1 = b1 == b0 ? x.s0 : __ldg(s + b1);
    x.split = static_cast<int>(((b0 + 1) << qshift) - j0);
  } else {
    const int64_t u = it - sp.nv;
    const int64_t j = u < sp.head ? u : u + V * sp.nv;
    x.i[0] = __ldg(idx + j);
#pragma unroll
    for (int l = 1; l < V; ++l) x.i[l] = -1;
    x.q[0] = static_cast<uint8_t>(__ldg(qv + j));
    x.s0 = x.s1 = __ldg(s + (j >> qshift));
    x.split = V;
  }
  return x;
}

// acc[i] += w * ((float)q * s) for the item's lanes with i in [0, d): the
// gathers of all lanes first (through L2: after a grid barrier another
// SM may have written the coordinate), then the stores.  kZero: every
// coordinate is known to hold +0 (the K-row sum's first row, after its
// zeros), so the gathers are skipped and +0 + w*(q*s) is stored: the same
// fadd, so -0 still lands as +0.
template <int V, bool kZero = false>
__device__ __forceinline__ void scatter_topk_item(float* acc,
                                                  const TopkItem<V>& x,
                                                  float w, int64_t d) {
  float a[V];
#pragma unroll
  for (int l = 0; l < V; ++l) {
    const int64_t i = x.i[l];
    a[l] = kZero || i < 0 || i >= d ? 0.f : __ldcg(acc + i);
  }
#pragma unroll
  for (int l = 0; l < V; ++l) {
    const int64_t i = x.i[l];
    if (i >= 0 && i < d) {
      const int q = static_cast<int8_t>(x.q[l / 4] >> (8 * (l % 4)));
      const float sc = l < x.split ? x.s0 : x.s1;
      acc[i] = __fadd_rn(a[l], __fmul_rn(w, __fmul_rn(static_cast<float>(q),
                                                      sc)));
    }
  }
}

// The fold's scatter: thread it of an exact grid takes item it.
template <int V, int T>
__global__ void __launch_bounds__(T)
    fold_topk_kernel(float* acc, const int32_t* __restrict__ idx,
                     const int8_t* __restrict__ qv,
                     const float* __restrict__ s, float w, TopkSpan sp,
                     int64_t d, int qshift) {
  const int64_t it = static_cast<int64_t>(blockIdx.x) * T + threadIdx.x;
  if (it < sp.items) {
    scatter_topk_item<V>(acc, load_topk_item<V>(idx, qv, s, sp, it, qshift),
                         w, d);
  }
}

// Row r of the K-row sum as this block sees it: the row's span, and the
// block's run [lo, hi) of its items (runs of whole warps, one a block).
struct TopkRowPlan {
  TopkSpan sp;
  int64_t lo, hi;
};

template <int V>
__device__ __forceinline__ TopkRowPlan topk_row_plan(const int32_t* idx,
                                                     const int8_t* qv,
                                                     int64_t nk,
                                                     int qshift) {
  const TopkSpan sp = topk_span<V>(idx, qv, nk, qshift);
  const int64_t g = gridDim.x;
  const int64_t run = ((sp.items + g - 1) / g + 31) / 32 * 32;
  const int64_t lo = blockIdx.x * run;
  return TopkRowPlan{sp, lo, lo + run < sp.items ? lo + run : sp.items};
}

// This thread's items of one row of the K-row sum, its first one
// ``first`` when ``loaded`` (loaded before the zeros), the others loaded
// here.
template <int V, int T, bool kZero>
__device__ __forceinline__ void aggregate_topk_row(
    float* out, const int32_t* __restrict__ idx,
    const int8_t* __restrict__ qv, const float* __restrict__ s, int64_t nk,
    float w, int64_t d, int qshift, const TopkItem<V>& first, bool loaded) {
  const TopkRowPlan pl = topk_row_plan<V>(idx, qv, nk, qshift);
  int64_t it = pl.lo + threadIdx.x;
  if (loaded && it < pl.hi) {
    scatter_topk_item<V, kZero>(out, first, w, d);
    it += T;
  }
  for (; it < pl.hi; it += T) {
    scatter_topk_item<V, kZero>(
        out, load_topk_item<V>(idx, qv, s, pl.sp, it, qshift), w, d);
  }
}

// The K-row sum in one cooperative launch (grid: the card's resident
// blocks): the first R rows' items of this thread loaded, the zeros
// written (16-byte stores from out's first 16-byte boundary), then the
// rows in order, a grid barrier before each; row 0 adds to the zeros
// without reading them back.
template <int V, int T, int R>
__global__ void __launch_bounds__(T)
    aggregate_topk_kernel(const int32_t* __restrict__ idx,
                          const int8_t* __restrict__ qv,
                          const float* __restrict__ s,
                          const float* __restrict__ w, float* out, int64_t k,
                          int64_t nk, int64_t d, int qshift) {
  static_assert(R >= 1, "row 0 comes from the prefetch");
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t nb = nk >> qshift;
  TopkItem<V> pre[R];
  float wr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < k) {
      const TopkRowPlan pl = topk_row_plan<V>(idx + r * nk, qv + r * nk, nk,
                                              qshift);
      const int64_t it = pl.lo + threadIdx.x;
      if (it < pl.hi) {
        pre[r] = load_topk_item<V>(idx + r * nk, qv + r * nk, s + r * nb,
                                   pl.sp, it, qshift);
      }
      wr[r] = __ldg(w + r);
    }
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * T + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * T;
  int64_t zh = (16 - reinterpret_cast<uintptr_t>(out) % 16) % 16 / 4;
  if (zh > d) zh = d;
  const int64_t nz = (d - zh) / 4;
  for (int64_t v = tid; v < nz; v += nthreads) {
    reinterpret_cast<float4*>(out + zh)[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < zh) out[tid] = 0.f;
  if (tid < d - zh - 4 * nz) out[zh + 4 * nz + tid] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < k) {
      grid.sync();
      if (r == 0) {
        aggregate_topk_row<V, T, true>(out, idx, qv, s, nk, wr[0], d, qshift,
                                       pre[0], true);
      } else {
        aggregate_topk_row<V, T, false>(out, idx + r * nk, qv + r * nk,
                                        s + r * nb, nk, wr[r], d, qshift,
                                        pre[r], true);
      }
    }
  }
  for (int64_t r = R; r < k; ++r) {
    grid.sync();
    aggregate_topk_row<V, T, false>(out, idx + r * nk, qv + r * nk,
                                    s + r * nb, nk, __ldg(w + r), d, qshift,
                                    pre[0], false);
  }
}

inline size_t weights_smem(int64_t k) {
  return static_cast<size_t>(k + 1) * sizeof(float);
}

// The rows of a quantized (K, Dq) buffer: int8 lanes (Q8Rows) or packed
// int4 bytes (Q4Rows).
template <class Rows>
Rows quant_rows(const void* q, const void* scales, int64_t dq, int qshift);

template <>
Q8Rows quant_rows<Q8Rows>(const void* q, const void* scales, int64_t dq,
                          int qshift) {
  return Q8Rows{static_cast<const int8_t*>(q),
                static_cast<const float*>(scales), dq, dq >> qshift, qshift};
}

template <>
Q4Rows quant_rows<Q4Rows>(const void* q, const void* scales, int64_t dq,
                          int qshift) {
  return Q4Rows{static_cast<const uint8_t*>(q),
                static_cast<const float*>(scales), dq >> 1, dq >> qshift,
                qshift};
}

template <class Rows>
int launch_aggregate(const void* q, const void* scales, const void* w,
                     const void* p, void* out, int64_t k, int64_t dq,
                     int64_t n, float lr, float alpha, int mode, int poly,
                     int qshift, void* stream) {
  const Rows rows = quant_rows<Rows>(q, scales, dq, qshift);
  aggregate_kernel<Rows><<<grid_for(n), kThreads, weights_smem(k),
                           static_cast<cudaStream_t>(stream)>>>(
      rows, static_cast<const float*>(w), static_cast<const float*>(p),
      static_cast<float*>(out), k, n, lr, alpha, mode, poly);
  return static_cast<int>(cudaGetLastError());
}

template <class Rows>
int launch_sdga(const void* q, const void* scales, const void* w,
                const void* p, const void* m, const void* e, void* op,
                void* om, void* oe, int64_t k, int64_t dq, int64_t d,
                float lr, float alpha, float mu, float anchor, float decay,
                float omd, int poly, int qshift, void* stream) {
  const Rows rows = quant_rows<Rows>(q, scales, dq, qshift);
  sdga_kernel<Rows><<<grid_for(d), kThreads, weights_smem(k),
                      static_cast<cudaStream_t>(stream)>>>(
      rows, static_cast<const float*>(w), static_cast<const float*>(p),
      static_cast<const float*>(m), static_cast<const float*>(e),
      static_cast<float*>(op), static_cast<float*>(om),
      static_cast<float*>(oe), k, d, lr, alpha, mu, anchor, decay, omd,
      poly);
  return static_cast<int>(cudaGetLastError());
}

// Lanes a thread and threads a block of the q4 fold: 4 lanes x 128 timed
// fastest at the paper CNN's Dq (0.0100 ms against the earlier
// grid-stride design's 0.0114 on one H100); 2 lanes were 0.0111 and
// slower at 64 threads, 8 and 16 lanes 0.0115-0.0140 (every block size),
// 256 and 512 threads 0.0001-0.0003 slower (csrc/fold_variants.cu, timed
// by kernels/hold_timing.py).  Keep in step with
// tests/test_torch_fold_q4.py, which models the lane partition from them.
constexpr int kFoldQ4Vec = 4;
constexpr int kFoldQ4Threads = 128;
// The same for the q8 fold: 4 lanes x 128 timed fastest at the paper
// CNN's Dq (0.01059 ms against the earlier grid-stride design's 0.01165
// on one "NVIDIA H100 80GB HBM3, 700.00 W"); 4 x 256 0.01066, 4 x 64
// and 4 x 512 0.0109, 2 lanes 0.0114-0.0163, 8 lanes 0.0120-0.0125, 16
// lanes 0.0140-0.0144 (csrc/fold_variants.cu, timed by
// kernels/hold_timing.py).  Keep in step with tests/test_torch_fold_q8.py.
constexpr int kFoldQ8Vec = 4;
constexpr int kFoldQ8Threads = 128;
// Lanes a thread, threads a block and rows loaded together of the q4
// K-row aggregate: 8 x 128 x 4 timed fastest at K = 4 on the paper CNN's
// Dq (fedsgd 0.01341 ms, avg 0.01120, against the earlier grid-stride
// design's 0.02074 / 0.01987 on one "NVIDIA H100 80GB HBM3, 700.00 W");
// 8 x 256 x 4 0.01386 / 0.01155, 4 lanes x 4 rows 0.0143-0.0145 /
// 0.0131-0.0132, 16 lanes 0.0170-0.0183 / 0.0149-0.0156, one row at a
// time 0.0149-0.0183 / 0.0129-0.0156 (csrc/aggregate_variants.cu, timed
// by kernels/hold_timing.py).  Keep in step with
// tests/test_torch_aggregate_q4.py.
constexpr int kAggQ4Vec = 8;
constexpr int kAggQ4Threads = 128;
constexpr int kAggQ4Rows = 4;

// The quantized fold's kernel for Lanes: fold_q4_kernel or fold_q8_kernel.
template <class Lanes, int V, int T, bool kUnitBeta>
auto fold_q_kernel() {
  if constexpr (Lanes::kShift == 1) {
    return fold_q4_kernel<V, T, kUnitBeta>;
  } else {
    return fold_q8_kernel<V, T, kUnitBeta>;
  }
}

// A quantized fold (Int4Lanes: fold_q4_kernel, Int8Lanes: fold_q8_kernel)
// in one launch over exactly the threads fold_span needs (at least one):
// a thread a vector, the head's and the tail's lanes (fewer than V each,
// or every lane) riding along.
template <class Lanes, int V, int T>
int launch_fold_q(const void* acc, const void* q, const void* scales,
                  void* out, float w, float beta, int64_t dq, int qshift,
                  void* stream) {
  const FoldSpan sp = fold_span<Lanes, V>(acc, q, out, dq);
  int64_t threads = sp.nv > sp.head ? sp.nv : sp.head;
  if (threads < dq - sp.tail) threads = dq - sp.tail;
  const unsigned blocks =
      static_cast<unsigned>(threads > 0 ? (threads + T - 1) / T : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const float*>(acc);
  const auto* pq = static_cast<const uint8_t*>(q);
  const auto* ps = static_cast<const float*>(scales);
  auto* po = static_cast<float*>(out);
  const auto kernel = beta == 1.0f ? fold_q_kernel<Lanes, V, T, true>()
                                    : fold_q_kernel<Lanes, V, T, false>();
  kernel<<<blocks, T, 0, s>>>(pa, pq, ps, po, w, beta, sp, dq, qshift);
  return static_cast<int>(cudaGetLastError());
}

// The q4 K-row aggregate in one launch of aggregate_q4_kernel over
// exactly the threads agg_span needs (at least one), K weights of
// shared memory.  n: output lanes (D for fedsgd / mix, Dq for avg / sum).
template <int V, int T, int R>
int launch_aggregate_q4(const void* q, const void* scales, const void* w,
                        const void* p, void* out, int64_t k, int64_t dq,
                        int64_t n, float lr, float alpha, int mode, int poly,
                        int qshift, void* stream) {
  const bool with_p = mode == kFedsgd || mode == kMix;
  const AggSpan sp =
      agg_span<Int4Lanes, V>(q, dq >> 1, with_p ? p : nullptr, out, n,
                             qshift);
  const int64_t threads = sp.nv > n - sp.tail ? sp.nv : n - sp.tail;
  const unsigned blocks =
      static_cast<unsigned>(threads > 0 ? (threads + T - 1) / T : 1);
  aggregate_q4_kernel<V, T, R><<<blocks, T, weights_smem(k),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<const float*>(w), static_cast<const float*>(p),
      static_cast<float*>(out), k, dq, qshift, sp, n, lr, alpha, mode, poly);
  return static_cast<int>(cudaGetLastError());
}

// Lanes of one chunk of the f32 screen with kW warps of kL loads.
template <int kW, int kL>
constexpr int64_t screen_f32_chunk() {
  return int64_t{kW} * 32 * kL * 4;
}

// The f32 screen: one launch of screen_f32_kernel over a (chunks, K)
// grid, float4 loads when every row starts 16-byte aligned, else lane by
// lane (the same sums bitwise).  count: the K per-row counters, 0 before the launch and after
// it.  kW warps a block, kL loads a thread: the package's shape unless
// another is timed (csrc/screen_variants.cu).
template <int kW = kScreenF32Warps, int kL = kScreenF32Loads>
int launch_screen_f32(const void* u, void* part, void* count, void* out,
                      int64_t k, int64_t d, int64_t chunks, void* stream) {
  constexpr int64_t chunk = screen_f32_chunk<kW, kL>();
  if (chunks != (d + chunk - 1) / chunk) return -1;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(k));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* up = static_cast<const float*>(u);
  auto* pp = static_cast<float*>(part);
  auto* cp = static_cast<int*>(count);
  auto* op = static_cast<float*>(out);
  // every row starts 16-byte aligned: the first, and (K > 1) D % 4 == 0
  if (reinterpret_cast<uintptr_t>(u) % 16 == 0 && (k == 1 || d % 4 == 0)) {
    screen_f32_kernel<true, kW, kL><<<grid, kW * 32, 0, s>>>(up, pp, cp, op,
                                                             d, chunks);
  } else {
    screen_f32_kernel<false, kW, kL><<<grid, kW * 32, 0, s>>>(up, pp, cp, op,
                                                              d, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// A quantized screen: one launch of screen_q_kernel over a (chunks, K)
// grid, 16-byte loads when the rows start 16-byte aligned and a qblock is
// a multiple of 16 bytes (a row is then too), else one byte a lane.
// count: the K per-row counters, 0 before the launch and after it.  kW
// warps a block, kL loads a lane: the package's shape unless another is
// timed (csrc/screen_variants.cu).
template <bool kPacked, int kW = kScreenQWarps, int kL = kScreenQLoads>
int launch_screen_q(const void* q, const void* scales, void* part,
                    void* count, void* out, int64_t k, int64_t dq,
                    int qshift, int64_t chunks, void* stream) {
  const int64_t nb = dq >> qshift;
  const int64_t bbytes = (int64_t{1} << qshift) >> (kPacked ? 1 : 0);
  if (bbytes < 1) return -1;
  const int64_t qpw = screen_qpw(bbytes, int64_t{kL} * 512);
  const int64_t per_block = kW * qpw;
  if (chunks != (nb + per_block - 1) / per_block) return -1;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(k));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const float*>(scales);
  auto* pp = static_cast<float*>(part);
  auto* cp = static_cast<int*>(count);
  auto* op = static_cast<float*>(out);
  if (bbytes % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    screen_q_kernel<kPacked, true, kW, kL><<<grid, kW * 32, 0, s>>>(
        qp, sp, pp, cp, op, nb, bbytes, qpw, chunks);
  } else {
    screen_q_kernel<kPacked, false, kW, kL><<<grid, kW * 32, 0, s>>>(
        qp, sp, pp, cp, op, nb, bbytes, qpw, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kUnitBeta, class V>
int launch_fold_vec(const float* acc, const float* vec, float* out, float w,
                    float beta, int64_t d, int64_t head, cudaStream_t s) {
  constexpr int64_t kW = sizeof(V) / sizeof(float);
  if (head > d) head = d;
  const int64_t nv = (d - head) / kW;
  const int64_t tail = head + nv * kW;
  const int64_t threads = nv > 32 ? nv : 32;  // covers head and tail too
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  fold_kernel<kUnitBeta, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                              s>>>(acc, vec, out, w, beta, nv, head, tail,
                                   d - tail);
  return static_cast<int>(cudaGetLastError());
}

// The f32 fold in 8-byte vectors when acc, vec and out sit at the same
// offset mod 8, else one lane at a time.  A bank row starts every D * 4
// bytes, so it may start anywhere in a 128-byte line: the scalar head runs
// up to out's next line, so that each warp's 256 bytes of stores fill two
// whole lines (on a row 40 bytes into its line, stopping at the next
// 8-byte boundary instead timed 2 % slower).  One vector a thread over a
// grid of exactly the vectors, as PyTorch's elementwise kernels run.
template <bool kUnitBeta>
int launch_fold_f32(const void* acc, const void* vec, void* out, float w,
                    float beta, int64_t d, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(acc);
  const uintptr_t v = reinterpret_cast<uintptr_t>(vec);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const auto* pa = static_cast<const float*>(acc);
  const auto* pv = static_cast<const float*>(vec);
  auto* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((a - v) % 8 == 0 && (a - o) % 8 == 0)
    return launch_fold_vec<kUnitBeta, float2>(pa, pv, po, w, beta, d,
                                              (128 - o % 128) % 128 / 4, s);
  return launch_fold_vec<kUnitBeta, float>(pa, pv, po, w, beta, d, 0, s);
}

// The fold of one sparse row into out (acc and out may alias): at beta ==
// 1 in place, one launch of fold_topk_kernel over exactly the row's items;
// otherwise out = beta*acc first (scale_kernel, a dense pass no engine run
// takes: the engine folds top-k rows at beta 1 in place), then the
// scatter into out.
template <int V, int T>
int launch_fold_topk(const void* acc, const void* idx, const void* qv,
                     const void* scales, void* out, float w, float beta,
                     int64_t d, int64_t nk, int qshift, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (beta != 1.0f || acc != out) {
    scale_kernel<<<grid_for(d), kThreads, 0, s>>>(
        static_cast<const float*>(acc), static_cast<float*>(out), beta, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* ip = static_cast<const int32_t*>(idx);
  const auto* qp = static_cast<const int8_t*>(qv);
  const TopkSpan sp = topk_span<V>(ip, qp, nk, qshift);
  const int64_t blocks = sp.items > 0 ? (sp.items + T - 1) / T : 1;
  fold_topk_kernel<V, T><<<static_cast<unsigned>(blocks), T, 0, s>>>(
      static_cast<float*>(out), ip, qp, static_cast<const float*>(scales), w,
      sp, d, qshift);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxDevices = 64;

// Blocks of ``kernel`` (``threads`` a block, no dynamic shared memory) the
// current device holds resident at once, from its real register use:
// queried once per device into ``cache`` (one per kernel); 0 with the
// error in *err when a query fails.
template <class Kernel>
int64_t resident_blocks(Kernel kernel, int threads, int64_t* cache,
                        cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int per_sm = 0;
  int sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, 0);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (*err != cudaSuccess) return 0;
  const int64_t blocks = int64_t{per_sm} * sms;
  if (blocks < 1) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  if (dev < kMaxDevices) cache[dev] = blocks;
  return blocks;
}

// The K-row sum: one cooperative launch of aggregate_topk_kernel on the
// card's resident blocks (a refused launch, e.g.
// cudaErrorCooperativeLaunchTooLarge, is returned).
template <int V, int T, int R>
int launch_aggregate_topk(const void* idx, const void* qv,
                          const void* scales, const void* w, void* out,
                          int64_t k, int64_t nk, int64_t d, int qshift,
                          void* stream) {
  static int64_t cache[kMaxDevices] = {};
  cudaError_t err = cudaSuccess;
  const int64_t blocks =
      resident_blocks(aggregate_topk_kernel<V, T, R>, T, cache, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, aggregate_topk_kernel<V, T, R>,
                           static_cast<const int32_t*>(idx),
                           static_cast<const int8_t*>(qv),
                           static_cast<const float*>(scales),
                           static_cast<const float*>(w),
                           static_cast<float*>(out), k, nk, d, qshift);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).

int safl_fold_f32(const void* acc, const void* vec, void* out, float w,
                  float beta, int64_t d, void* stream) {
  return beta == 1.0f ? launch_fold_f32<true>(acc, vec, out, w, beta, d,
                                              stream)
                      : launch_fold_f32<false>(acc, vec, out, w, beta, d,
                                               stream);
}

int safl_fold_q8(const void* acc, const void* q, const void* scales,
                 void* out, float w, float beta, int64_t dq, int qshift,
                 void* stream) {
  return launch_fold_q<Int8Lanes, kFoldQ8Vec, kFoldQ8Threads>(
      acc, q, scales, out, w, beta, dq, qshift, stream);
}

// dq: lanes of acc (the packed row holds dq / 2 bytes).
int safl_fold_q4(const void* acc, const void* q, const void* scales,
                 void* out, float w, float beta, int64_t dq, int qshift,
                 void* stream) {
  return launch_fold_q<Int4Lanes, kFoldQ4Vec, kFoldQ4Threads>(
      acc, q, scales, out, w, beta, dq, qshift, stream);
}

int safl_aggregate_f32(const void* u, const void* w, const void* p,
                       void* out, int64_t k, int64_t d, float lr,
                       float alpha, int mode, int poly, void* stream) {
  const F32Rows rows{static_cast<const float*>(u), d};
  aggregate_kernel<F32Rows><<<grid_for(d), kThreads, weights_smem(k),
                              static_cast<cudaStream_t>(stream)>>>(
      rows, static_cast<const float*>(w), static_cast<const float*>(p),
      static_cast<float*>(out), k, d, lr, alpha, mode, poly);
  return static_cast<int>(cudaGetLastError());
}

// n: output lanes (D for fedsgd / mix, Dq for avg / sum).
int safl_aggregate_q8(const void* q, const void* scales, const void* w,
                      const void* p, void* out, int64_t k, int64_t dq,
                      int64_t n, float lr, float alpha, int mode, int poly,
                      int qshift, void* stream) {
  return launch_aggregate<Q8Rows>(q, scales, w, p, out, k, dq, n, lr, alpha,
                                  mode, poly, qshift, stream);
}

int safl_aggregate_q4(const void* q, const void* scales, const void* w,
                      const void* p, void* out, int64_t k, int64_t dq,
                      int64_t n, float lr, float alpha, int mode, int poly,
                      int qshift, void* stream) {
  return launch_aggregate_q4<kAggQ4Vec, kAggQ4Threads, kAggQ4Rows>(
      q, scales, w, p, out, k, dq, n, lr, alpha, mode, poly, qshift, stream);
}

int sdga_aggregate_f32(const void* u, const void* w, const void* p,
                       const void* m, const void* e, void* op, void* om,
                       void* oe, int64_t k, int64_t d, float lr,
                       float alpha, float mu, float anchor, float decay,
                       float omd, int poly, void* stream) {
  const F32Rows rows{static_cast<const float*>(u), d};
  sdga_kernel<F32Rows><<<grid_for(d), kThreads, weights_smem(k),
                         static_cast<cudaStream_t>(stream)>>>(
      rows, static_cast<const float*>(w), static_cast<const float*>(p),
      static_cast<const float*>(m), static_cast<const float*>(e),
      static_cast<float*>(op), static_cast<float*>(om),
      static_cast<float*>(oe), k, d, lr, alpha, mu, anchor, decay, omd,
      poly);
  return static_cast<int>(cudaGetLastError());
}

int sdga_aggregate_q8(const void* q, const void* scales, const void* w,
                      const void* p, const void* m, const void* e, void* op,
                      void* om, void* oe, int64_t k, int64_t dq, int64_t d,
                      float lr, float alpha, float mu, float anchor,
                      float decay, float omd, int poly, int qshift,
                      void* stream) {
  return launch_sdga<Q8Rows>(q, scales, w, p, m, e, op, om, oe, k, dq, d, lr,
                             alpha, mu, anchor, decay, omd, poly, qshift,
                             stream);
}

int sdga_aggregate_q4(const void* q, const void* scales, const void* w,
                      const void* p, const void* m, const void* e, void* op,
                      void* om, void* oe, int64_t k, int64_t dq, int64_t d,
                      float lr, float alpha, float mu, float anchor,
                      float decay, float omd, int poly, int qshift,
                      void* stream) {
  return launch_sdga<Q4Rows>(q, scales, w, p, m, e, op, om, oe, k, dq, d, lr,
                             alpha, mu, anchor, decay, omd, poly, qshift,
                             stream);
}

// The screens return -1 when the caller's scratch has another number of
// chunks per row than the kernels' constants give (it sizes nothing
// then), else cudaGetLastError() after the launch.  count: K int32
// per-row counters, zero (each launch leaves them zero).
int screen_rows_f32(const void* u, void* part, void* count, void* out,
                    int64_t k, int64_t d, int64_t chunks, void* stream) {
  return launch_screen_f32<>(u, part, count, out, k, d, chunks, stream);
}

int screen_rows_q8(const void* q, const void* scales, void* part,
                   void* count, void* out, int64_t k, int64_t dq,
                   int qshift, int64_t chunks, void* stream) {
  return launch_screen_q<false>(q, scales, part, count, out, k, dq, qshift,
                                chunks, stream);
}

// dq: lanes per row (the packed row holds dq / 2 bytes).
int screen_rows_q4(const void* q, const void* scales, void* part,
                   void* count, void* out, int64_t k, int64_t dq,
                   int qshift, int64_t chunks, void* stream) {
  return launch_screen_q<true>(q, scales, part, count, out, k, dq, qshift,
                               chunks, stream);
}

// The fold of one sparse row into acc (out may be acc: the in-place fold
// into a bank row).  beta == 1 in place scatters the nk lanes only (1*acc
// is exact), one launch; otherwise a dense pass writes out = beta*acc
// first, a second launch.
int safl_fold_topk(const void* acc, const void* idx, const void* qv,
                   const void* scales, void* out, float w, float beta,
                   int64_t d, int64_t nk, int qshift, void* stream) {
  return launch_fold_topk<kTopkFoldVec, kTopkThreads>(
      acc, idx, qv, scales, out, w, beta, d, nk, qshift, stream);
}

// out (d,) = sum_k w[k] * scatter(dequant(qv[k]), idx[k]), the rows added
// in row order over zeros: one cooperative launch.
int safl_aggregate_topk(const void* idx, const void* qv, const void* scales,
                        const void* w, void* out, int64_t k, int64_t nk,
                        int64_t d, int qshift, void* stream) {
  return launch_aggregate_topk<kTopkAggVec, kTopkAggThreads,
                               kTopkPrefetch>(idx, qv, scales, w, out, k, nk,
                                              d, qshift, stream);
}

}  // extern "C"
