// Other designs of safl_agg.cu's top-k kernels, built and timed only by
// ``repro_torch/kernels/hold_timing.py`` beside the package's kernels; no
// wrapper of the package calls them.  Every lane rounds as the package's
// (acc + w*((float)q*s) through the _rn intrinsics, rows in row order),
// so each is bitwise equal to the plain versions.
//
//   safl_fold_topk_gridstride, safl_aggregate_topk_memset
//       the earlier designs, as they stood (namespace parent below): the
//       fold one lane a thread in a grid-stride loop over at most
//       132 * 16 blocks of 256 (after a dense beta*acc pass unless beta
//       == 1 in place), and the K-row sum as a cudaMemsetAsync of the
//       output, then one launch of that scatter per row in row order on
//       the stream.  The package's safl_fold_topk / safl_aggregate_topk
//       arguments.
//   safl_fold_topk_v<V>_t<T>
//       the package's fold (included from safl_agg.cu) with V lanes a
//       thread (1, 2, 4 or 8) and blocks of T threads (128, 256 or 512);
//       the package's safl_fold_topk arguments.
//   safl_aggregate_topk_v<V>_t<T>
//       the package's cooperative K-row sum with V lanes a thread (1, 2 or
//       4) and blocks of T threads (256, 512 or 1024); the package's
//       safl_aggregate_topk arguments.
//   topk_scatter_probe, topk_barrier_probe
//       the K-row sum's two costs apart (namespace probe): one row's
//       scatter, one lane a thread in blocks of 128, as the fold's
//       read-modify-write, its gathers alone or its stores alone; and a
//       cooperative launch of k grid barriers and nothing else.

#include "safl_agg.cu"

namespace parent {

// acc[idx[j]] += w * ((float)qv[j] * s[j >> qshift]) for the lanes j < nk
// with idx[j] in [0, d); the weight is *wp when wp is set (the K-row sum
// reads row k's weight from the device), else w.
__global__ void scatter_topk_kernel(float* acc,
                                    const int32_t* __restrict__ idx,
                                    const int8_t* __restrict__ qv,
                                    const float* __restrict__ s,
                                    const float* __restrict__ wp, float w,
                                    int64_t nk, int64_t d, int qshift) {
  const float wk = wp != nullptr ? *wp : w;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < nk; j += stride) {
    const int64_t i = idx[j];
    if (i < 0 || i >= d) continue;
    const float v = __fmul_rn(
        wk, __fmul_rn(static_cast<float>(qv[j]), s[j >> qshift]));
    acc[i] = __fadd_rn(acc[i], v);
  }
}

}  // namespace parent

namespace probe {

// One lane a thread of a row's scatter: kMode 0 acc[i] = acc[i] + w*(q*s)
// (the fold's lane), 1 the gathers alone (a lane that reads the sentinel
// 12345 writes it back, so the loads are kept), 2 the stores alone
// (acc[i] = w*(q*s)).
template <int kMode>
__global__ void __launch_bounds__(128)
    scatter_probe(float* acc, const int32_t* __restrict__ idx,
                  const int8_t* __restrict__ qv, const float* __restrict__ s,
                  float w, int64_t nk, int64_t d, int qshift) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * 128 + threadIdx.x;
  if (j >= nk) return;
  const int64_t i = idx[j];
  if (i < 0 || i >= d) return;
  const float v =
      __fmul_rn(w, __fmul_rn(static_cast<float>(qv[j]), s[j >> qshift]));
  if (kMode == 0) acc[i] = __fadd_rn(__ldcg(acc + i), v);
  if (kMode == 1) {
    const float a = __ldcg(acc + i);
    if (a == 12345.f) acc[i] = a;
  }
  if (kMode == 2) acc[i] = v;
}

__global__ void barrier_probe(int64_t k) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int64_t r = 0; r < k; ++r) grid.sync();
}

}  // namespace probe

extern "C" {

int safl_fold_topk_gridstride(const void* acc, const void* idx,
                              const void* qv, const void* scales, void* out,
                              float w, float beta, int64_t d, int64_t nk,
                              int qshift, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (beta != 1.0f || acc != out) {
    scale_kernel<<<grid_for(d), kThreads, 0, s>>>(
        static_cast<const float*>(acc), static_cast<float*>(out), beta, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  parent::scatter_topk_kernel<<<grid_for(nk), kThreads, 0, s>>>(
      static_cast<float*>(out), static_cast<const int32_t*>(idx),
      static_cast<const int8_t*>(qv), static_cast<const float*>(scales),
      nullptr, w, nk, d, qshift);
  return static_cast<int>(cudaGetLastError());
}

int safl_aggregate_topk_memset(const void* idx, const void* qv,
                               const void* scales, const void* w, void* out,
                               int64_t k, int64_t nk, int64_t d, int qshift,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(d) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nb = nk >> qshift;
  for (int64_t j = 0; j < k; ++j) {
    parent::scatter_topk_kernel<<<grid_for(nk), kThreads, 0, s>>>(
        static_cast<float*>(out), static_cast<const int32_t*>(idx) + j * nk,
        static_cast<const int8_t*>(qv) + j * nk,
        static_cast<const float*>(scales) + j * nb,
        static_cast<const float*>(w) + j, 0.f, nk, d, qshift);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

#define FOLD_TOPK_VARIANT(V, T)                                             \
  int safl_fold_topk_v##V##_t##T(const void* acc, const void* idx,          \
                                 const void* qv, const void* scales,        \
                                 void* out, float w, float beta, int64_t d, \
                                 int64_t nk, int qshift, void* stream) {    \
    return launch_fold_topk<V, T>(acc, idx, qv, scales, out, w, beta, d,    \
                                  nk, qshift, stream);                      \
  }

FOLD_TOPK_VARIANT(1, 128)
FOLD_TOPK_VARIANT(1, 256)
FOLD_TOPK_VARIANT(1, 512)
FOLD_TOPK_VARIANT(2, 128)
FOLD_TOPK_VARIANT(2, 256)
FOLD_TOPK_VARIANT(2, 512)
FOLD_TOPK_VARIANT(4, 128)
FOLD_TOPK_VARIANT(4, 256)
FOLD_TOPK_VARIANT(4, 512)
FOLD_TOPK_VARIANT(8, 128)
FOLD_TOPK_VARIANT(8, 256)
FOLD_TOPK_VARIANT(8, 512)

#define AGGREGATE_TOPK_VARIANT(V, T)                                        \
  int safl_aggregate_topk_v##V##_t##T(                                      \
      const void* idx, const void* qv, const void* scales, const void* w,   \
      void* out, int64_t k, int64_t nk, int64_t d, int qshift,              \
      void* stream) {                                                       \
    return launch_aggregate_topk<V, T, kTopkPrefetch>(                      \
        idx, qv, scales, w, out, k, nk, d, qshift, stream);                 \
  }

AGGREGATE_TOPK_VARIANT(1, 256)
AGGREGATE_TOPK_VARIANT(1, 512)
AGGREGATE_TOPK_VARIANT(1, 1024)
AGGREGATE_TOPK_VARIANT(2, 256)
AGGREGATE_TOPK_VARIANT(2, 512)
AGGREGATE_TOPK_VARIANT(2, 1024)
AGGREGATE_TOPK_VARIANT(4, 256)
AGGREGATE_TOPK_VARIANT(4, 512)
AGGREGATE_TOPK_VARIANT(4, 1024)

int topk_scatter_probe(int mode, void* acc, const void* idx, const void* qv,
                       const void* scales, float w, int64_t nk, int64_t d,
                       int qshift, void* stream) {
  const auto blocks = static_cast<unsigned>(nk > 0 ? (nk + 127) / 128 : 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<float*>(acc);
  const auto* ip = static_cast<const int32_t*>(idx);
  const auto* qp = static_cast<const int8_t*>(qv);
  const auto* sp = static_cast<const float*>(scales);
  if (mode == 0) {
    probe::scatter_probe<0><<<blocks, 128, 0, st>>>(a, ip, qp, sp, w, nk, d,
                                                     qshift);
  } else if (mode == 1) {
    probe::scatter_probe<1><<<blocks, 128, 0, st>>>(a, ip, qp, sp, w, nk, d,
                                                     qshift);
  } else {
    probe::scatter_probe<2><<<blocks, 128, 0, st>>>(a, ip, qp, sp, w, nk, d,
                                                     qshift);
  }
  return static_cast<int>(cudaGetLastError());
}

// k grid barriers on the card's resident blocks of ``threads``, at most
// ``max_blocks`` of them (0: no cap).
int topk_barrier_probe(int64_t k, int threads, int64_t max_blocks,
                       void* stream) {
  int dev = 0;
  int per_sm = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe::barrier_probe, threads, 0);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = int64_t{per_sm} * sms;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, probe::barrier_probe, k));
}

}  // extern "C"
