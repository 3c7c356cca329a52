// Other designs of safl_agg.cu's screens, built and timed only by
// ``repro_torch/kernels/hold_timing.py`` beside the package's kernels; no
// wrapper of the package calls them.
//
//   screen_rows_q8_two_launch, screen_rows_q4_two_launch
//       the earlier design, two launches a call, as it stood (namespace
//       two_launch below, unchanged): block (c, row) reduces
//       kScreenQBlocks = 32 quantization blocks of the row (a warp per
//       block, one byte a lane per load) into a (K, chunks) scratch, then
//       screen_finish, one block per row, sums the row's partials; another
//       f32 order than the package's kernel, so within rtol=1e-5 of the
//       plain versions and of it.  Arguments: safl_agg.cu's earlier
//       screen_rows_q8 (q, scales, part, out, k, dq, qshift, chunks,
//       stream), chunks = ceil(nb / 32).
//   screen_rows_q8_w2l2, screen_rows_q4_w2l2
//       the package's one-launch kernel (included from safl_agg.cu) with 2
//       warps a block and 2 loads a lane (1,053 blocks at the paper CNN's
//       q8 row, 106 over a top-k upload's values); the package's
//       screen_rows_q8 arguments, chunks = ceil(nb / (2 * qpw)) with qpw
//       = max(1, 1024 / bytes per qblock).
//   screen_rows_f32_two_launch
//       the f32 screen's earlier design, two launches a call, as it stood
//       (namespace two_launch): block (c, row) sums lanes [c*8192,
//       (c+1)*8192) of the row, one 4-byte lane a thread per step of a
//       strided loop (32 steps), into a (K, chunks) scratch, then
//       screen_finish sums the row's partials; another f32 order than the
//       package's kernel, so within rtol=1e-5 of the plain version and of
//       it.  Arguments: safl_agg.cu's earlier screen_rows_f32 (u, part,
//       out, k, d, chunks, stream), chunks = ceil(d / 8192).
//   screen_rows_f32_w<W>_l<L>
//       the package's one-launch f32 kernel (included from safl_agg.cu)
//       with W warps a block (4, 8 or 16) and L float4 loads a thread (2,
//       4, 8 or 16; not 16 x 16): W * 32 * L * 4 lanes a chunk; the
//       package's screen_rows_f32 arguments, chunks = ceil(d / (W * 128 *
//       L)).

#include "safl_agg.cu"

namespace two_launch {

constexpr int kThreads = 256;

// Nibble ``high`` of byte b as a two's complement int4 in [-8, 7]: shift
// it to the top of a 32-bit word, then back with an arithmetic shift.
__device__ __forceinline__ int nibble(uint8_t b, int high) {
  return static_cast<int>(static_cast<uint32_t>(b) << (high ? 24 : 28)) >>
         28;
}

constexpr int kWarps = kThreads / 32;
// q8 quantization blocks per warp, and per chunk (one block of threads).
constexpr int kQBlocksPerWarp = 4;
constexpr int64_t kScreenQBlocks = kWarps * kQBlocksPerWarp;

__device__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;  // lane 0 holds the warp's sum
}

// Thread 0 gets the block's sum of one value per thread: a shuffle tree
// in each warp, then the same tree over the warp sums (padded with 0).
__device__ float block_sum(float v, float* smem) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) s = warp_sum(lane < kWarps ? smem[lane] : 0.f);
  return s;
}

// Block (c, row): warp w takes the kQBlocksPerWarp quantization blocks
// b = (c*kWarps + w)*kQBlocksPerWarp + j in order.  sum q^2 over a block
// is an int32 sum (exact and order-free: 512 * 128^2 on q8, 512 * 8^2 on
// the packed int4 rows (kPacked, two lanes per byte), both below 2^24, so
// the sum converts to f32 exactly), then (q2 * s) * s in f32 as the
// reference's oracle forms it; thread 0 sums the warps' terms in warp
// order.  An Inf scale gives Inf (or 0 * Inf = NaN over an all-zero
// block): non-finite.
template <bool kPacked>
__global__ void screen_partial_q(const uint8_t* __restrict__ q,
                                 const float* __restrict__ s,
                                 float* __restrict__ part, int64_t dq,
                                 int64_t nb, int qshift, int64_t chunks) {
  __shared__ float smem[kWarps];
  const int64_t c = blockIdx.x;
  const int64_t row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // bytes per quantization block and per row
  const int64_t bbytes = (int64_t{1} << qshift) >> (kPacked ? 1 : 0);
  const uint8_t* qr = q + row * (kPacked ? dq >> 1 : dq);
  const float* sr = s + row * nb;
  float acc = 0.f;
  for (int j = 0; j < kQBlocksPerWarp; ++j) {
    const int64_t b = (c * kWarps + warp) * kQBlocksPerWarp + j;
    if (b >= nb) break;  // uniform across the warp
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
    const float sb = sr[b];
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(static_cast<float>(q2), sb), sb));
  }
  if (lane == 0) smem[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, smem[w]);
    part[row * chunks + c] = t;
  }
}

// f32 lanes per chunk of a row in the earlier f32 screen (32 a thread).
constexpr int64_t kScreenChunk = 8192;

// Block (c, row): the sum of squares of lanes [c*chunk, (c+1)*chunk) of
// the row, masked at the ragged end.
__global__ void screen_partial_f32(const float* __restrict__ u,
                                   float* __restrict__ part, int64_t d,
                                   int64_t chunks) {
  __shared__ float smem[kWarps];
  const int64_t c = blockIdx.x;
  const int64_t row = blockIdx.y;
  const float* r = u + row * d;
  const int64_t lo = c * kScreenChunk;
  const int64_t hi = lo + kScreenChunk < d ? lo + kScreenChunk : d;
  float s = 0.f;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float x = r[i];
    s = __fadd_rn(s, __fmul_rn(x, x));
  }
  s = block_sum(s, smem);
  if (threadIdx.x == 0) part[row * chunks + c] = s;
}

// Block row: out[row] = the sum of the row's partials, strided per thread
// in index order, then block_sum.
__global__ void screen_finish(const float* __restrict__ part,
                              float* __restrict__ out, int64_t chunks) {
  __shared__ float smem[kWarps];
  const int64_t row = blockIdx.x;
  float s = 0.f;
  for (int64_t i = threadIdx.x; i < chunks; i += kThreads) {
    s = __fadd_rn(s, part[row * chunks + i]);
  }
  s = block_sum(s, smem);
  if (threadIdx.x == 0) out[row] = s;
}

// A screen's second launch, once the first launched: cudaGetLastError()
// after the two.
inline int launch_finish(const void* part, void* out, int64_t k,
                         int64_t chunks, cudaStream_t s) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  screen_finish<<<static_cast<unsigned>(k), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), chunks);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPacked>
int launch_screen_q(const void* q, const void* scales, void* part,
                    void* out, int64_t k, int64_t dq, int qshift,
                    int64_t chunks, void* stream) {
  const int64_t nb = dq >> qshift;
  if (chunks != (nb + kScreenQBlocks - 1) / kScreenQBlocks) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  screen_partial_q<kPacked><<<dim3(static_cast<unsigned>(chunks),
                                   static_cast<unsigned>(k)),
                              kThreads, 0, s>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(part), dq, nb, qshift, chunks);
  return launch_finish(part, out, k, chunks, s);
}

inline int launch_screen_f32(const void* u, void* part, void* out, int64_t k,
                             int64_t d, int64_t chunks, void* stream) {
  if (chunks != (d + kScreenChunk - 1) / kScreenChunk) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  screen_partial_f32<<<dim3(static_cast<unsigned>(chunks),
                            static_cast<unsigned>(k)),
                       kThreads, 0, s>>>(static_cast<const float*>(u),
                                         static_cast<float*>(part), d,
                                         chunks);
  return launch_finish(part, out, k, chunks, s);
}

}  // namespace two_launch

extern "C" {

int screen_rows_q8_two_launch(const void* q, const void* scales, void* part,
                              void* out, int64_t k, int64_t dq, int qshift,
                              int64_t chunks, void* stream) {
  return two_launch::launch_screen_q<false>(q, scales, part, out, k, dq,
                                            qshift, chunks, stream);
}

// dq: lanes per row (the packed row holds dq / 2 bytes).
int screen_rows_q4_two_launch(const void* q, const void* scales, void* part,
                              void* out, int64_t k, int64_t dq, int qshift,
                              int64_t chunks, void* stream) {
  return two_launch::launch_screen_q<true>(q, scales, part, out, k, dq,
                                           qshift, chunks, stream);
}

int screen_rows_q8_w2l2(const void* q, const void* scales, void* part,
                        void* count, void* out, int64_t k, int64_t dq,
                        int qshift, int64_t chunks, void* stream) {
  return launch_screen_q<false, 2, 2>(q, scales, part, count, out, k, dq,
                                      qshift, chunks, stream);
}

int screen_rows_q4_w2l2(const void* q, const void* scales, void* part,
                        void* count, void* out, int64_t k, int64_t dq,
                        int qshift, int64_t chunks, void* stream) {
  return launch_screen_q<true, 2, 2>(q, scales, part, count, out, k, dq,
                                     qshift, chunks, stream);
}

int screen_rows_f32_two_launch(const void* u, void* part, void* out,
                               int64_t k, int64_t d, int64_t chunks,
                               void* stream) {
  return two_launch::launch_screen_f32(u, part, out, k, d, chunks, stream);
}

#define SCREEN_F32_VARIANT(W, L)                                          \
  int screen_rows_f32_w##W##_l##L(const void* u, void* part, void* count, \
                                  void* out, int64_t k, int64_t d,        \
                                  int64_t chunks, void* stream) {         \
    return launch_screen_f32<W, L>(u, part, count, out, k, d, chunks,     \
                                   stream);                               \
  }

SCREEN_F32_VARIANT(4, 2)
SCREEN_F32_VARIANT(4, 4)
SCREEN_F32_VARIANT(4, 8)
SCREEN_F32_VARIANT(4, 16)
SCREEN_F32_VARIANT(8, 2)
SCREEN_F32_VARIANT(8, 4)
SCREEN_F32_VARIANT(8, 16)
SCREEN_F32_VARIANT(16, 2)
SCREEN_F32_VARIANT(16, 4)
SCREEN_F32_VARIANT(16, 8)

}  // extern "C"
