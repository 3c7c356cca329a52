// Other designs of safl_agg.cu's q4 K-row aggregate, built and timed only
// by ``repro_torch/kernels/hold_timing.py`` (and, for its poly weights,
// held bitwise against the package's kernel by ``chip_smoke.py`` phase
// 3) beside the package's kernel; no wrapper of the package calls them.
// Each takes the package's safl_aggregate_q4 arguments and rounds each
// lane as it does (sum_j w_j*(n*s) in row order, then the mode's step).
//
//   safl_aggregate_q4_gridstride
//                        the aggregate's first design, as it stood
//                        (aggregate_kernel<Q4Rows>, included from
//                        safl_agg.cu): thread 0 of each block loads the K
//                        weights serially into shared memory, then one
//                        lane a thread per step of a grid-stride loop over
//                        at most 132 * 16 blocks of 256, each row's 1-byte
//                        load and scale through the Q4Rows functor
//   safl_aggregate_q4_v<V>_t<T>_r<R>
//                        the package's kernel (aggregate_q4_kernel) with V
//                        lanes a thread (4, 8 or 16), blocks of T threads
//                        (128 or 256) and R rows loaded together (1 or 4)

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

#define AGG_Q4_VARIANT(V, T, R)                                              \
  int safl_aggregate_q4_v##V##_t##T##_r##R(                                  \
      const void* q, const void* scales, const void* w, const void* p,       \
      void* out, int64_t k, int64_t dq, int64_t n, float lr, float alpha,    \
      int mode, int poly, int qshift, void* stream) {                        \
    return launch_aggregate_q4<V, T, R>(q, scales, w, p, out, k, dq, n, lr,  \
                                        alpha, mode, poly, qshift, stream);  \
  }

AGG_Q4_VARIANT(4, 128, 1)
AGG_Q4_VARIANT(4, 128, 4)
AGG_Q4_VARIANT(4, 256, 1)
AGG_Q4_VARIANT(4, 256, 4)
AGG_Q4_VARIANT(8, 128, 1)
AGG_Q4_VARIANT(8, 128, 4)
AGG_Q4_VARIANT(8, 256, 1)
AGG_Q4_VARIANT(8, 256, 4)
AGG_Q4_VARIANT(16, 128, 1)
AGG_Q4_VARIANT(16, 128, 4)
AGG_Q4_VARIANT(16, 256, 1)
AGG_Q4_VARIANT(16, 256, 4)

}  // extern "C"
