// The q8 server round's large-K int8-dot reduction for Hopper (sm_90a),
// bound with ctypes through a plain C interface (see kernels/build.py and
// kernels/int8dot.py).
//
//   weighted_sum_q8_int8dot  q (K, Dq) int8 rows, s (K, nb) f32 block
//       scales, w (K,) f32 weights, optionally cs (nb,) f32 coefficient
//       scales -> out (Dq,) f32 with, for block b and lane j of it,
//
//         c_kb  = w_k * s_kb
//         S_b   = max(cs_b, 1e-30), cs_b = max_k |c_kb| * inv unless given
//         cq_kb = clip(rint(c_kb / S_b), -127, 127)
//         out   = (float)(sum_k cq_kb * q_k[b*qblock + j]) * S_b
//
//       the inner sum an int8 x int8 product accumulated in int32 (exact:
//       |cq * q| <= 127^2, and the host refuses K with 127^2 K >= 2^31).
//       It replaces the reference's XLA einsum
//       (src/repro/kernels/ref.py weighted_sum_q8_int8dot_ref), not a
//       Pallas kernel.
//
// For each block b the reduction is a (1, K) x (K, qblock) integer
// product: a batched GEMV, bound by the K * Dq bytes of q.  One launch,
// one CTA a block.  The CTA makes the block's coefficient scale (each
// thread the absmax of its strided rows' |w_k * s_kb|, then xor shuffles
// and one shared-memory pass: max is exact and order-free), then walks
// the K rows in chunks of kChunk: its threads write the chunk's cq to
// shared memory, and each thread of the first qblock / 4 streams its four
// lanes of every row of the chunk, one 4-byte load a row (a warp reads 128
// contiguous bytes of a row), the loads of kUnroll rows issued before
// their products, and sums cq * level into four int32 accumulators.  The
// lanes leave as one float4 store.  Integer sums are exact
// in any order, and the division, products and rounding use the _rn
// intrinsics and rintf (half to even, as jnp.round and torch.round), so
// the kernel equals the plain PyTorch version bitwise.  NaN propagates as
// in jnp.max / torch.amax and jnp.maximum / torch.clamp: a NaN coefficient
// makes its block's scale NaN (fmaxf would drop it) and so the block's
// output; a coefficient whose quotient is NaN is level 0, as the float ->
// int8 conversion of the plain version gives.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;  // rows whose cq one pass holds in shared memory
constexpr int kUnroll = 8;    // row loads in flight a thread
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// clip(rint(c / cs), -127, 127) as an int; a NaN quotient gives 0.
__device__ __forceinline__ int coeff_level(float c, float cs) {
  float r = rintf(__fdiv_rn(c, cs));
  r = r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);
  return r != r ? 0 : __float2int_rz(r);
}

// The four int8 lanes of a row at p (4-byte aligned), as a word (byte i
// = lane i).
__device__ __forceinline__ int load_lanes(const int8_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}

// Byte i of word as a signed level.
template <int kByte>
__device__ __forceinline__ int level(int word) {
  return static_cast<int8_t>(static_cast<uint32_t>(word) >> (8 * kByte));
}

template <bool kGiven>
__global__ void int8dot_kernel(const int8_t* __restrict__ q,
                               const float* __restrict__ s,
                               const float* __restrict__ w,
                               const float* __restrict__ cs_given,
                               float* __restrict__ out, int64_t k_rows,
                               int64_t dq, int64_t nb, int qblock,
                               float inv) {
  __shared__ int cq_s[kChunk];
  __shared__ float part[kMaxThreads / 32];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;

  float cs;
  if (kGiven) {
    cs = cs_given[b];
  } else {
    float m = 0.0f;
    for (int64_t k = t; k < k_rows; k += blockDim.x) {
      m = nan_max(m, fabsf(__fmul_rn(w[k], s[k * nb + b])));
    }
    for (int off = 16; off > 0; off >>= 1) {
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if ((t & 31) == 0) part[t >> 5] = m;
    __syncthreads();
    m = part[0];
    for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) {
      m = nan_max(m, part[i]);
    }
    cs = __fmul_rn(m, inv);
  }
  cs = nan_max(cs, 1e-30f);

  const bool active = 4 * t < qblock;
  const int8_t* row = q + b * qblock + 4 * t;
  int acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
  for (int64_t k0 = 0; k0 < k_rows; k0 += kChunk) {
    const int n = static_cast<int>(
        k_rows - k0 < kChunk ? k_rows - k0 : kChunk);
    __syncthreads();  // the previous chunk's levels are consumed
    for (int j = t; j < n; j += blockDim.x) {
      const int64_t k = k0 + j;
      cq_s[j] = coeff_level(__fmul_rn(w[k], s[k * nb + b]), cs);
    }
    __syncthreads();
    if (!active) continue;
    const int8_t* p = row + k0 * dq;
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
      int words[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        words[u] = load_lanes(p + (j + u) * dq);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = cq_s[j + u];
        acc0 += c * level<0>(words[u]);
        acc1 += c * level<1>(words[u]);
        acc2 += c * level<2>(words[u]);
        acc3 += c * level<3>(words[u]);
      }
    }
    for (; j < n; ++j) {
      const int word = load_lanes(p + j * dq);
      const int c = cq_s[j];
      acc0 += c * level<0>(word);
      acc1 += c * level<1>(word);
      acc2 += c * level<2>(word);
      acc3 += c * level<3>(word);
    }
  }
  if (!active) return;
  float4 o;
  o.x = __fmul_rn(__int2float_rn(acc0), cs);
  o.y = __fmul_rn(__int2float_rn(acc1), cs);
  o.z = __fmul_rn(__int2float_rn(acc2), cs);
  o.w = __fmul_rn(__int2float_rn(acc3), cs);
  *reinterpret_cast<float4*>(out + b * qblock + 4 * t) = o;
}

template <bool kGiven>
int launch(const void* q, const void* s, const void* w, const void* cs,
           void* out, int64_t k, int64_t dq, int qblock, float inv,
           cudaStream_t stream) {
  const int64_t nb = dq / qblock;
  // a thread for every four lanes, whole warps
  const int threads = ((qblock / 4 + 31) / 32) * 32;
  int8dot_kernel<kGiven><<<static_cast<unsigned>(nb), threads, 0,
                           stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<const float*>(cs),
      static_cast<float*>(out), k, dq, nb, qblock, inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); 1
// (cudaErrorInvalidValue) for a shape the kernel does not take: qblock a
// multiple of 4 in [4, 4096], Dq a positive multiple of qblock, K >= 1, q
// 4-byte and out 16-byte aligned.  cs may be null (the kernel makes the
// scales).
int weighted_sum_q8_int8dot(const void* q, const void* s, const void* w,
                            const void* cs, void* out, int64_t k, int64_t dq,
                            int qblock, float inv, void* stream) {
  if (qblock < 4 || qblock > 4 * kMaxThreads || qblock % 4 || k < 1 ||
      dq < qblock || dq % qblock || reinterpret_cast<uintptr_t>(q) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cs != nullptr) {
    return launch<true>(q, s, w, cs, out, k, dq, qblock, inv, st);
  }
  return launch<false>(q, s, w, cs, out, k, dq, qblock, inv, st);
}

}  // extern "C"
