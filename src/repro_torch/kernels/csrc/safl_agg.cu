// SAFL server-channel kernels for Hopper (sm_90a), bound with ctypes
// through a plain C interface (see kernels/build.py and kernels/safl_agg.py).
//
//   safl_fold_f32       o = beta*acc + w*vec over one (D,) f32 row
//                       (replaces src/repro/kernels/safl_agg.py safl_fold)
//   safl_aggregate_f32  K-way weighted reduction of (K, D) f32 rows with
//                       the server step fused: modes fedsgd / avg / mix /
//                       sum, optional (1+tau)^-alpha discount
//                       (replaces src/repro/kernels/safl_agg.py
//                       safl_aggregate)
//
// Both are pure bandwidth: a handful of flops per element against 4 bytes
// moved per operand.  The design is one coalesced streaming pass, each
// thread owning output lanes in a grid-stride loop (the ragged end of D is
// masked by the loop bound; nothing is padded), so the bytes moved are the
// bound: fold 3*D*4, aggregate (K+2)*D*4 (fedsgd/mix) or (K+1)*D*4
// (avg/sum).
//
// Floating-point order is part of the contract: every product and sum goes
// through the _rn intrinsics, which nvcc never contracts into an FMA, so
// the kernels round exactly like the plain PyTorch versions beside their
// wrappers (acc + w*v, p - lr*(g/wsum), weights summed k = 0..K-1).  That
// keeps the streaming channel (a chain of folds) bit-equal to the buffered
// one (one aggregate), as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

enum AggMode { kFedsgd = 0, kAvg = 1, kMix = 2, kSum = 3 };

inline int grid_for(int64_t d) {
  int64_t blocks = (d + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// acc and out may alias (the in-place fold into a bank row): each element
// is read and written by the same thread, so neither is __restrict__.
template <bool kUnitBeta>
__global__ void fold_kernel(const float* acc, const float* __restrict__ vec,
                            float* out, float w, float beta, int64_t d) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < d; i += stride) {
    const float wv = __fmul_rn(w, vec[i]);
    const float a = acc[i];
    out[i] = kUnitBeta ? __fadd_rn(a, wv) : __fadd_rn(__fmul_rn(beta, a), wv);
  }
}

// Dynamic shared memory holds the K reduction weights and their sum,
// computed once per block by thread 0 in a fixed order.
__global__ void aggregate_kernel(const float* __restrict__ u,
                                 const float* __restrict__ w_in,
                                 const float* __restrict__ p,
                                 float* __restrict__ out, int64_t k,
                                 int64_t d, float lr, float alpha, int mode,
                                 int poly) {
  extern __shared__ float sw[];
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
  const float wsum = sw[k];
  const float wsafe = fmaxf(wsum, 1e-12f);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < d; i += stride) {
    float acc = 0.f;
    for (int64_t j = 0; j < k; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(sw[j], u[j * d + i]));
    }
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

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int safl_fold_f32(const void* acc, const void* vec, void* out, float w,
                  float beta, int64_t d, void* stream) {
  const int blocks = grid_for(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (beta == 1.0f) {
    fold_kernel<true><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(acc), static_cast<const float*>(vec),
        static_cast<float*>(out), w, beta, d);
  } else {
    fold_kernel<false><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(acc), static_cast<const float*>(vec),
        static_cast<float*>(out), w, beta, d);
  }
  return static_cast<int>(cudaGetLastError());
}

int safl_aggregate_f32(const void* u, const void* w, const void* p,
                       void* out, int64_t k, int64_t d, float lr,
                       float alpha, int mode, int poly, void* stream) {
  const int blocks = grid_for(d);
  const size_t smem = static_cast<size_t>(k + 1) * sizeof(float);
  aggregate_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<const float*>(p), static_cast<float*>(out), k, d, lr,
      alpha, mode, poly);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
