// Other designs of safl_agg.cu's q4 and q8 K-row aggregates, built and
// timed only by ``repro_torch/kernels/hold_timing.py`` (and, for their
// poly weights, held bitwise against the package's kernels by
// ``chip_smoke.py`` phase 3, which also times the parents in phase 4)
// beside the package's kernels; no wrapper of the package calls them.
// Each takes the package's safl_aggregate_q4 / safl_aggregate_q8
// arguments and rounds each lane as it does (sum_j w_j*(n*s) in row
// order, then the mode's step).
//
//   safl_aggregate_q4_gridstride, safl_aggregate_q8_gridstride
//                        the aggregates' first design, as it stood
//                        (aggregate_kernel<Q4Rows> / <Q8Rows>, included
//                        from safl_agg.cu): thread 0 of each block loads
//                        the K weights serially into shared memory, then
//                        one lane a thread per step of a grid-stride loop
//                        over at most 132 * 16 blocks of 256, each row's
//                        1-byte load and scale through the Rows functor
//   safl_aggregate_q4_v<V>_t<T>_r<R>, safl_aggregate_q8_v<V>_t<T>_r<R>
//                        the package's kernels (aggregate_q4_kernel,
//                        aggregate_q8_kernel) with V lanes a thread (4, 8
//                        or 16: on q8 a 4-, 8- or 16-byte load a row),
//                        blocks of T threads (128 or 256) and R rows
//                        loaded together (1 or 4)

#include "safl_agg.cu"

extern "C" {

int safl_aggregate_q4_gridstride(const void* q, const void* scales,
                                 const void* w, const void* p, void* out,
                                 int64_t k, int64_t dq, int64_t n, float lr,
                                 float alpha, int mode, int poly, int qshift,
                                 void* stream) {
  return launch_aggregate<Q4Rows>(q, scales, w, p, out, k, dq, n, lr, alpha,
                                  mode, poly, qshift, stream);
}

int safl_aggregate_q8_gridstride(const void* q, const void* scales,
                                 const void* w, const void* p, void* out,
                                 int64_t k, int64_t dq, int64_t n, float lr,
                                 float alpha, int mode, int poly, int qshift,
                                 void* stream) {
  return launch_aggregate<Q8Rows>(q, scales, w, p, out, k, dq, n, lr, alpha,
                                  mode, poly, qshift, stream);
}

#define AGG_VARIANT(WIRE, LANES, V, T, R)                                    \
  int safl_aggregate_##WIRE##_v##V##_t##T##_r##R(                            \
      const void* q, const void* scales, const void* w, const void* p,       \
      void* out, int64_t k, int64_t dq, int64_t n, float lr, float alpha,    \
      int mode, int poly, int qshift, void* stream) {                        \
    return launch_aggregate_q<LANES, V, T, R>(q, scales, w, p, out, k, dq,   \
                                              n, lr, alpha, mode, poly,      \
                                              qshift, stream);               \
  }
#define AGG_VARIANTS(WIRE, LANES)  \
  AGG_VARIANT(WIRE, LANES, 4, 128, 1)  \
  AGG_VARIANT(WIRE, LANES, 4, 128, 4)  \
  AGG_VARIANT(WIRE, LANES, 4, 256, 1)  \
  AGG_VARIANT(WIRE, LANES, 4, 256, 4)  \
  AGG_VARIANT(WIRE, LANES, 8, 128, 1)  \
  AGG_VARIANT(WIRE, LANES, 8, 128, 4)  \
  AGG_VARIANT(WIRE, LANES, 8, 256, 1)  \
  AGG_VARIANT(WIRE, LANES, 8, 256, 4)  \
  AGG_VARIANT(WIRE, LANES, 16, 128, 1) \
  AGG_VARIANT(WIRE, LANES, 16, 128, 4) \
  AGG_VARIANT(WIRE, LANES, 16, 256, 1) \
  AGG_VARIANT(WIRE, LANES, 16, 256, 4)

AGG_VARIANTS(q4, Int4Lanes)
AGG_VARIANTS(q8, Int8Lanes)

}  // extern "C"
