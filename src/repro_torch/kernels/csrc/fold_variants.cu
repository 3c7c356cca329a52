// Other designs of safl_agg.cu's f32 and quantized folds, built and
// timed only by ``repro_torch/kernels/hold_timing.py`` beside the
// package's kernels; no wrapper of the package calls them.  Each lane's
// arithmetic is the package kernels' (beta*acc + w*vec, w*((float)n*s)
// on q8 / q4, through the _rn intrinsics), so each is bitwise equal to
// ``safl_fold_plain`` / ``safl_fold_q8_plain`` / ``safl_fold_q4_plain``.
//
//   fold_gridstride_f32  one 4-byte lane a thread per step of a
//                        grid-stride loop over at most 132 * 16 blocks
//                        (the fold's first design)
//   fold_vec4_f32        16-byte vectors (float4), one a thread over an
//                        exact grid, after a scalar head up to the 16-byte
//                        boundary; refuses (returns cudaErrorInvalidValue)
//                        rows whose addresses differ mod 16
//   fold_vec2_f32        8-byte vectors as the package's kernel, but the
//                        scalar head runs up to the rows' next 8-byte
//                        boundary only (not out's next 128-byte line), so
//                        a warp's stores into a row that starts inside a
//                        line straddle three lines; refuses rows whose
//                        addresses differ mod 8
//   safl_fold_q4_gridstride, safl_fold_q8_gridstride
//                        the quantized folds' first design
//                        (fold_rows_kernel<Q4Rows> / <Q8Rows>, below): one
//                        lane a thread per step of a grid-stride loop over
//                        at most 132 * 16 blocks of 256, a 1-byte load of
//                        the lane's (packed) byte and its scale through
//                        the Rows functor
//   safl_fold_q4_v<V>_t<T>, safl_fold_q8_v<V>_t<T>
//                        the package's quantized folds (included from
//                        safl_agg.cu) with V lanes a thread (2, 4, 8 or
//                        16) and blocks of T threads (64, 128, 256 or 512)
//
// The f32 designs take the package's safl_fold_f32 arguments, the
// quantized designs its safl_fold_q8 / safl_fold_q4 arguments.

#include "safl_agg.cu"

namespace {

// The fold of one quantized row (row 0 of ``row``: Q8Rows or Q4Rows),
// dequantized on the fly; acc and out may alias.
template <class Rows, bool kUnitBeta>
__global__ void fold_rows_kernel(const float* acc, Rows row, float* out,
                                 float w, float beta, int64_t dq) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < dq; i += stride) {
    const float wv = __fmul_rn(w, row(0, i));
    const float a = acc[i];
    out[i] = kUnitBeta ? __fadd_rn(a, wv) : __fadd_rn(__fmul_rn(beta, a), wv);
  }
}

template <class Rows>
int launch_fold(const void* acc, const void* q, const void* scales,
                void* out, float w, float beta, int64_t dq, int qshift,
                void* stream) {
  const Rows row = quant_rows<Rows>(q, scales, dq, qshift);
  const int blocks = grid_for(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (beta == 1.0f) {
    fold_rows_kernel<Rows, true><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(acc), row, static_cast<float*>(out), w,
        beta, dq);
  } else {
    fold_rows_kernel<Rows, false><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(acc), row, static_cast<float*>(out), w,
        beta, dq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace f32_variants {

template <bool kUnitBeta>
__device__ __forceinline__ float fold_lane(float a, float v, float w,
                                           float beta) {
  const float wv = __fmul_rn(w, v);
  return kUnitBeta ? __fadd_rn(a, wv) : __fadd_rn(__fmul_rn(beta, a), wv);
}

template <bool kUnitBeta>
__global__ void gridstride_kernel(const float* acc,
                                  const float* __restrict__ vec, float* out,
                                  float w, float beta, int64_t d) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < d; i += stride) {
    out[i] = fold_lane<kUnitBeta>(acc[i], vec[i], w, beta);
  }
}

__device__ __forceinline__ float4 fold_vec(float4 a, float4 v, float w,
                                           float beta, bool unit) {
  return unit ? make_float4(fold_lane<true>(a.x, v.x, w, beta),
                            fold_lane<true>(a.y, v.y, w, beta),
                            fold_lane<true>(a.z, v.z, w, beta),
                            fold_lane<true>(a.w, v.w, w, beta))
              : make_float4(fold_lane<false>(a.x, v.x, w, beta),
                            fold_lane<false>(a.y, v.y, w, beta),
                            fold_lane<false>(a.z, v.z, w, beta),
                            fold_lane<false>(a.w, v.w, w, beta));
}

__device__ __forceinline__ float2 fold_vec(float2 a, float2 v, float w,
                                           float beta, bool unit) {
  return unit ? make_float2(fold_lane<true>(a.x, v.x, w, beta),
                            fold_lane<true>(a.y, v.y, w, beta))
              : make_float2(fold_lane<false>(a.x, v.x, w, beta),
                            fold_lane<false>(a.y, v.y, w, beta));
}

// Thread i folds vector i of the lanes from ``head`` on, and lane i of the
// scalar head and of the scalar tail.
template <bool kUnitBeta, class V>
__global__ void vec_kernel(const float* acc, const float* __restrict__ vec,
                           float* out, float w, float beta, int64_t nv,
                           int64_t head, int64_t tail, int64_t n_tail) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < nv) {
    const V a = reinterpret_cast<const V*>(acc + head)[i];
    const V v = reinterpret_cast<const V*>(vec + head)[i];
    reinterpret_cast<V*>(out + head)[i] = fold_vec(a, v, w, beta, kUnitBeta);
  }
  if (i < head) out[i] = fold_lane<kUnitBeta>(acc[i], vec[i], w, beta);
  if (i < n_tail) {
    out[tail + i] = fold_lane<kUnitBeta>(acc[tail + i], vec[tail + i], w,
                                         beta);
  }
}

template <class V>
int launch_vec(const void* acc, const void* vec, void* out, float w,
               float beta, int64_t d, int64_t head, void* stream) {
  constexpr int64_t kW = sizeof(V) / sizeof(float);
  if (head > d) head = d;
  const int64_t nv = (d - head) / kW;
  const int64_t tail = head + nv * kW;
  const int64_t threads = nv > 32 ? nv : 32;  // covers head and tail too
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const float*>(acc);
  const auto* pv = static_cast<const float*>(vec);
  auto* po = static_cast<float*>(out);
  if (beta == 1.0f) {
    vec_kernel<true, V><<<blocks, kThreads, 0, s>>>(pa, pv, po, w, beta, nv,
                                                    head, tail, d - tail);
  } else {
    vec_kernel<false, V><<<blocks, kThreads, 0, s>>>(pa, pv, po, w, beta,
                                                     nv, head, tail,
                                                     d - tail);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32_variants

extern "C" {

int fold_gridstride_f32(const void* acc, const void* vec, void* out, float w,
                        float beta, int64_t d, void* stream) {
  int64_t blocks = (d + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const float*>(acc);
  const auto* pv = static_cast<const float*>(vec);
  auto* po = static_cast<float*>(out);
  if (beta == 1.0f) {
    f32_variants::gridstride_kernel<true><<<static_cast<unsigned>(blocks),
                                            kThreads, 0, s>>>(pa, pv, po, w,
                                                              beta, d);
  } else {
    f32_variants::gridstride_kernel<false><<<static_cast<unsigned>(blocks),
                                             kThreads, 0, s>>>(pa, pv, po, w,
                                                               beta, d);
  }
  return static_cast<int>(cudaGetLastError());
}

int fold_vec4_f32(const void* acc, const void* vec, void* out, float w,
                  float beta, int64_t d, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(acc);
  const uintptr_t v = reinterpret_cast<uintptr_t>(vec);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if ((a - v) % 16 != 0 || (a - o) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return f32_variants::launch_vec<float4>(acc, vec, out, w, beta, d,
                                          (16 - a % 16) % 16 / 4, stream);
}

int fold_vec2_f32(const void* acc, const void* vec, void* out, float w,
                  float beta, int64_t d, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(acc);
  const uintptr_t v = reinterpret_cast<uintptr_t>(vec);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if ((a - v) % 8 != 0 || (a - o) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return f32_variants::launch_vec<float2>(acc, vec, out, w, beta, d,
                                          a % 8 / 4, stream);
}

int safl_fold_q4_gridstride(const void* acc, const void* q,
                            const void* scales, void* out, float w,
                            float beta, int64_t dq, int qshift,
                            void* stream) {
  return launch_fold<Q4Rows>(acc, q, scales, out, w, beta, dq, qshift,
                             stream);
}

int safl_fold_q8_gridstride(const void* acc, const void* q,
                            const void* scales, void* out, float w,
                            float beta, int64_t dq, int qshift,
                            void* stream) {
  return launch_fold<Q8Rows>(acc, q, scales, out, w, beta, dq, qshift,
                             stream);
}

#define FOLD_Q_VARIANT(WIRE, LANES, V, T)                                   \
  int safl_fold_##WIRE##_v##V##_t##T(const void* acc, const void* q,        \
                                     const void* scales, void* out, float w,\
                                     float beta, int64_t dq, int qshift,    \
                                     void* stream) {                        \
    return launch_fold_q<LANES, V, T>(acc, q, scales, out, w, beta, dq,     \
                                      qshift, stream);                      \
  }
#define FOLD_Q_VARIANTS(WIRE, LANES, V) \
  FOLD_Q_VARIANT(WIRE, LANES, V, 64)    \
  FOLD_Q_VARIANT(WIRE, LANES, V, 128)   \
  FOLD_Q_VARIANT(WIRE, LANES, V, 256)   \
  FOLD_Q_VARIANT(WIRE, LANES, V, 512)

FOLD_Q_VARIANTS(q4, Int4Lanes, 2)
FOLD_Q_VARIANTS(q4, Int4Lanes, 4)
FOLD_Q_VARIANTS(q4, Int4Lanes, 8)
FOLD_Q_VARIANTS(q4, Int4Lanes, 16)
FOLD_Q_VARIANTS(q8, Int8Lanes, 2)
FOLD_Q_VARIANTS(q8, Int8Lanes, 4)
FOLD_Q_VARIANTS(q8, Int8Lanes, 8)
FOLD_Q_VARIANTS(q8, Int8Lanes, 16)

}  // extern "C"
