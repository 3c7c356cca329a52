// Row-wise int8 absmax quantization for Hopper (sm_90a), bound with ctypes
// through a plain C interface (see kernels/build.py and
// kernels/quantize.py).
//
//   quantize_int8    x (R, B) f32 -> q (R, B) int8 and s (R,) f32:
//                    s = max(absmax(x_r) * inv, 1e-12), inv = f32(1/127)
//                    from the caller, q = clip(rint(x / s), -127, 127)
//                    (replaces src/repro/kernels/quantize.py quantize_int8)
//   dequantize_int8  q (R, B) int8 and s (R,) -> (float)q * s (replaces
//                    quantize.py dequantize_int8)
//
// Both are pure bandwidth (a few flops per lane against 5 bytes moved).
// quantize takes one warp per row: each lane keeps a strided running
// absmax over the row, the warp combines them with shuffles (max is exact
// and order-free, so the tree needs no fixed order), then every lane
// quantizes its strided lanes with the row's scale.  dequantize takes one
// block per row.  The division, product and rounding use the _rn
// intrinsics and rintf (half to even, as jnp.round and torch.round), so
// both equal the plain PyTorch versions bitwise.  NaN propagates as in
// jnp.max / torch.amax and jnp.maximum / torch.clamp: a NaN lane makes the
// row's scale NaN (fmaxf would drop it), and a lane whose quotient is NaN
// stores 0, as the float -> int8 conversion of PyTorch's plain version
// does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// max(a, b) that returns NaN when either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void quantize_int8_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ s, int64_t r,
                                     int64_t b, float inv) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= r) return;  // whole warps only: the shuffles stay full
  const float* xr = x + row * b;
  float m = 0.f;
  for (int64_t i = lane; i < b; i += 32) m = nan_max(m, fabsf(xr[i]));
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  const float v = __fmul_rn(m, inv);
  const float sc = (v >= 1e-12f || v != v) ? v : 1e-12f;
  if (lane == 0) s[row] = sc;
  int8_t* qr = q + row * b;
  for (int64_t i = lane; i < b; i += 32) {
    float y = rintf(__fdiv_rn(xr[i], sc));
    y = y > 127.f ? 127.f : (y < -127.f ? -127.f : y);
    qr[i] = y != y ? int8_t{0} : static_cast<int8_t>(static_cast<int>(y));
  }
}

__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ s,
                                       float* __restrict__ out, int64_t b) {
  const int64_t row = blockIdx.x;
  const float sc = s[row];
  for (int64_t i = threadIdx.x; i < b; i += kThreads) {
    out[row * b + i] = __fmul_rn(static_cast<float>(q[row * b + i]), sc);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).

int quantize_int8(const void* x, void* q, void* s, int64_t r, int64_t b,
                  float inv, void* stream) {
  const int64_t blocks = (r + kWarps - 1) / kWarps;
  quantize_int8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), r, b, inv);
  return static_cast<int>(cudaGetLastError());
}

int dequantize_int8(const void* q, const void* s, void* out, int64_t r,
                    int64_t b, void* stream) {
  dequantize_int8_kernel<<<static_cast<unsigned>(r), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
