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
// quantize at B = 512, the package's only width (quantize_array's
// block), with x's rows 16-byte and q's rows 4-byte aligned, takes one
// warp a row with the row held in registers (quantize_int8_b512_kernel):
// each lane issues its 4 float4 loads (lanes 4l .. 4l+3 of each
// 128-lane slice) before any arithmetic, takes its absmax over them (an
// integer max of the bits), the warp combines the lanes' maxima by xor
// shuffles (max is exact and order-free, so the tree needs no fixed
// order), and each float4's four int8 leave packed in one 32-bit store:
// 16 bytes read and 4 written a lane a slice, the row read once, the
// levels made without a conversion instruction.  Any other B, or a
// misaligned row, takes quantize_int8_kernel (the host picks by B and
// the two pointers): one warp a row, a strided running absmax over the
// row, then every lane quantizes its strided lanes, reading the row
// again.  Both give the same bits.  dequantize at B = 512 with q's rows
// 4-byte and out's 16-byte aligned takes one warp a row as well
// (dequantize_int8_b512_kernel): lane l loads the packed words l, 32 + l,
// 64 + l and 96 + l of its row (levels 4l .. 4l+3 of each 128-level
// slice: 128 contiguous bytes a warp load) before any arithmetic and the
// row's scale, makes each word's four levels as floats without a
// conversion instruction (XOR 0x80808080, each byte set under 0x4B by a
// byte permute, less 2^23 + 128: exact, -128 and +0 included) and stores
// them as one float4 (512 contiguous bytes a warp store).  Any other B,
// or a misaligned row, takes dequantize_int8_kernel: one block a row, a
// level a thread at a time, converted with I2F.  Both give the same bits.
// The division, product and rounding use the _rn
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

// The row's scale from its absmax m: max(m * inv, 1e-12), NaN kept.
__device__ __forceinline__ float row_scale(float m, float inv) {
  const float v = __fmul_rn(m, inv);
  return (v >= 1e-12f || v != v) ? v : 1e-12f;
}

// One lane's level: clip(rint(x / sc), -127, 127), a NaN quotient 0.
__device__ __forceinline__ int quant_lane(float x, float sc) {
  float y = rintf(__fdiv_rn(x, sc));
  y = y > 127.f ? 127.f : (y < -127.f ? -127.f : y);
  return y != y ? 0 : static_cast<int>(y);
}

// Any B, any alignment: one warp a row, the row read twice.
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
  const float sc = row_scale(m, inv);
  if (lane == 0) s[row] = sc;
  int8_t* qr = q + row * b;
  for (int64_t i = lane; i < b; i += 32) {
    qr[i] = static_cast<int8_t>(quant_lane(xr[i], sc));
  }
}

// |x|'s bits: for floats without a sign, integer order is their order,
// and a NaN (exponent all ones, mantissa not 0) lies above +Inf, so the
// integer max of a row's |x| bits is its absmax, NaN if it holds one (as
// nan_max gives it) in two integer instructions a value.
__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & 0x7FFFFFFFu;
}

// The four levels of a float4 x / sc as one word (lane j at byte j), for
// a finite sc: every quotient is then finite (|x| <= absmax, sc >=
// absmax * inv), so no NaN check, and fmaxf / fminf clip as the
// comparisons do.  Each level v in [-127, 127] becomes a byte without a
// conversion instruction (F2I runs at 1/8 of the f32 rate on sm_90): 2^23
// + 128 + v is exact and holds v + 128 in its low byte; three byte
// permutes gather the four low bytes, and XOR 0x80 makes each v.
__device__ __forceinline__ uint32_t quant_word(float4 a, float sc) {
  const float x[4] = {a.x, a.y, a.z, a.w};
  uint32_t b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = fminf(fmaxf(rintf(__fdiv_rn(x[j], sc)), -127.f), 127.f);
    b[j] = __float_as_uint(__fadd_rn(v, 8388736.0f));
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040u),
                     __byte_perm(b[2], b[3], 0x0040u), 0x5410u) ^
         0x80808080u;
}

// B = 512: G lanes a row (32: a warp, 16: a half-warp), each holding
// 128 / G float4 of it, and RW rows a lane group one after another (all
// their loads issued first), in blocks of T threads.  Lane l's float4 m
// of a row is float4 G*m + l, and its packed levels the word G*m + l of
// the row's q: lane 4l + j of each slice of 4G lanes at byte j of word
// l.  Rows past r load nothing and store nothing, but every lane of a
// warp takes part in its shuffles.  A row whose scale is Inf (it holds
// an Inf) or NaN (a NaN) stores zeros: every quotient is then +-0 or NaN,
// which the general kernel stores as 0 lane by lane.
template <int G, int RW, int T>
__global__ void __launch_bounds__(T)
    quantize_int8_b512_kernel(const float4* __restrict__ x,
                              uint32_t* __restrict__ q,
                              float* __restrict__ s, int64_t r, float inv) {
  static_assert(G == 16 || G == 32, "a warp or a half-warp a row");
  constexpr int kL = 128 / G;  // float4 a lane a row
  const int lane = threadIdx.x % G;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * (T / G) + threadIdx.x / G) * RW;
  float4 v[RW][kL];
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    if (row0 + k < r) {
#pragma unroll
      for (int m = 0; m < kL; ++m) {
        v[k][m] = x[(row0 + k) * 128 + G * m + lane];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    const bool live = row0 + k < r;
    uint32_t mx = 0u;
    if (live) {
#pragma unroll
      for (int m = 0; m < kL; ++m) {
        mx = max(mx, abs_bits(v[k][m].x));
        mx = max(mx, abs_bits(v[k][m].y));
        mx = max(mx, abs_bits(v[k][m].z));
        mx = max(mx, abs_bits(v[k][m].w));
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (!live) continue;
    const float sc = row_scale(__uint_as_float(mx), inv);
    if (lane == 0) s[row0 + k] = sc;
    uint32_t* qr = q + (row0 + k) * 128 + lane;
    if (fabsf(sc) <= 3.402823466e38f) {  // finite (false for NaN)
#pragma unroll
      for (int m = 0; m < kL; ++m) qr[G * m] = quant_word(v[k][m], sc);
    } else {
#pragma unroll
      for (int m = 0; m < kL; ++m) qr[G * m] = 0u;
    }
  }
}

// Lanes a row, rows a lane group and threads a block of the B = 512
// kernel: a warp a row in blocks of 256 timed fastest over the paper
// CNN's 4,209 rows (0.00973 ms against the general kernel's 0.01133 on
// one "NVIDIA H100 80GB HBM3, 700.00 W"); blocks of 128 0.00986, two
// rows a warp 0.0103-0.0105, a half-warp a row 0.0102-0.0104
// (csrc/quantize_variants.cu, timed by kernels/hold_timing.py).  Keep in
// step with tests/test_torch_quantize_int8.py.
constexpr int kQuantLanes = 32;
constexpr int kQuantRows = 1;
constexpr int kQuantThreads = 256;

// Whether x (R, b) f32 and q (R, b) int8 take the B = 512 kernel: b =
// 512, x 16-byte and q 4-byte aligned (then every row is).
inline bool quantize_b512_ok(const void* x, const void* q, int64_t b) {
  return b == 512 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 4 == 0;
}

template <int G, int RW, int T>
int launch_quantize_b512(const void* x, void* q, void* s, int64_t r,
                         float inv, void* stream) {
  constexpr int64_t kRowsBlock = T / G * RW;
  quantize_int8_b512_kernel<G, RW, T>
      <<<static_cast<unsigned>((r + kRowsBlock - 1) / kRowsBlock), T, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float4*>(x), static_cast<uint32_t*>(q),
          static_cast<float*>(s), r, inv);
  return static_cast<int>(cudaGetLastError());
}

int launch_quantize_general(const void* x, void* q, void* s, int64_t r,
                            int64_t b, float inv, void* stream) {
  const int64_t blocks = (r + kWarps - 1) / kWarps;
  quantize_int8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), r, b, inv);
  return static_cast<int>(cudaGetLastError());
}

// Any B, any alignment: one block a row, the general path.
__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ s,
                                       float* __restrict__ out, int64_t b) {
  const int64_t row = blockIdx.x;
  const float sc = s[row];
  for (int64_t i = threadIdx.x; i < b; i += kThreads) {
    out[row * b + i] = __fmul_rn(static_cast<float>(q[row * b + i]), sc);
  }
}

// The four int8 levels of a packed word (lane j at byte j) as exact
// floats, without a conversion instruction (I2F runs at a quarter of the
// f32 rate on sm_90): the word XORed with 0x80808080 holds n + 128 in
// each byte, the float with the bits 0x4B000000 | (n + 128) is 2^23 + n +
// 128, and 2^23 + 128 less it is n exactly (n = 0 gives +0.0, as
// (float)0 does; n = -128 gives -128.0).  Each byte goes under 0x4B by
// one byte permute (Int8Lanes::levels in safl_agg.cu).
__device__ __forceinline__ float4 word_levels(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // bytes (u.j, 0, 0, 0x4B) of u and 0x4B000000
    x[j] = __fsub_rn(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + j)),
        8388736.0f);
  }
  return make_float4(x[0], x[1], x[2], x[3]);
}

// B = 512: G lanes a row (32: a warp, 16: a half-warp), each holding 128 /
// G packed words of it, and RW rows a lane group one after another (all
// their words and scales loaded first), in blocks of T threads over an
// exact grid.  Lane l's word m of a row is word G*m + l, and its four
// levels the row's float4 G*m + l (levels 4l .. 4l+3 of each slice of 4G
// levels).  Each level is multiplied by the row's scale with one
// rounding (__fmul_rn), as the plain version's product: a NaN scale gives
// NaN, an Inf one +-Inf, or NaN at a level 0.  No shuffles, so rows past
// r simply do nothing.
template <int G, int RW, int T>
__global__ void __launch_bounds__(T)
    dequantize_int8_b512_kernel(const uint32_t* __restrict__ q,
                                const float* __restrict__ s,
                                float4* __restrict__ out, int64_t r) {
  static_assert(G == 16 || G == 32, "a warp or a half-warp a row");
  constexpr int kL = 128 / G;  // words a lane a row
  const int lane = threadIdx.x % G;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * (T / G) + threadIdx.x / G) * RW;
  uint32_t w[RW][kL];
  float sc[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    if (row0 + k < r) {
#pragma unroll
      for (int m = 0; m < kL; ++m) {
        w[k][m] = q[(row0 + k) * 128 + G * m + lane];
      }
      sc[k] = s[row0 + k];
    }
  }
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    if (row0 + k >= r) continue;
    float4* orow = out + (row0 + k) * 128 + lane;
#pragma unroll
    for (int m = 0; m < kL; ++m) {
      const float4 v = word_levels(w[k][m]);
      orow[G * m] = make_float4(__fmul_rn(v.x, sc[k]), __fmul_rn(v.y, sc[k]),
                                __fmul_rn(v.z, sc[k]), __fmul_rn(v.w, sc[k]));
    }
  }
}

// Lanes a row, rows a lane group and threads a block of the B = 512
// dequantize kernel, a warp a row in blocks of 256 as quantize's; the
// half-warp, two-row and 128-thread layouts are timed beside it
// (csrc/quantize_variants.cu, kernels/hold_timing.py).  Keep in step with
// tests/test_torch_quantize_int8.py.
constexpr int kDequantLanes = 32;
constexpr int kDequantRows = 1;
constexpr int kDequantThreads = 256;

// Whether q (R, b) int8 and out (R, b) f32 take the B = 512 kernel: b =
// 512, q 4-byte and out 16-byte aligned (then every row is).
inline bool dequantize_b512_ok(const void* q, const void* out, int64_t b) {
  return b == 512 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <int G, int RW, int T>
int launch_dequantize_b512(const void* q, const void* s, void* out,
                           int64_t r, void* stream) {
  constexpr int64_t kRowsBlock = T / G * RW;
  dequantize_int8_b512_kernel<G, RW, T>
      <<<static_cast<unsigned>((r + kRowsBlock - 1) / kRowsBlock), T, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(q), static_cast<const float*>(s),
          static_cast<float4*>(out), r);
  return static_cast<int>(cudaGetLastError());
}

int launch_dequantize_general(const void* q, const void* s, void* out,
                              int64_t r, int64_t b, void* stream) {
  dequantize_int8_kernel<<<static_cast<unsigned>(r), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).

// x (R, b) f32 -> q (R, b) int8 and s (R,): the B = 512 kernel where
// quantize_b512_ok, else the general one; the same bits either way.
int quantize_int8(const void* x, void* q, void* s, int64_t r, int64_t b,
                  float inv, void* stream) {
  if (quantize_b512_ok(x, q, b)) {
    return launch_quantize_b512<kQuantLanes, kQuantRows, kQuantThreads>(
        x, q, s, r, inv, stream);
  }
  return launch_quantize_general(x, q, s, r, b, inv, stream);
}

// q (R, b) int8 and s (R,) -> out (R, b) f32: the B = 512 kernel where
// dequantize_b512_ok, else the general one; the same bits either way.
int dequantize_int8(const void* q, const void* s, void* out, int64_t r,
                    int64_t b, void* stream) {
  if (dequantize_b512_ok(q, out, b)) {
    return launch_dequantize_b512<kDequantLanes, kDequantRows,
                                  kDequantThreads>(q, s, out, r, stream);
  }
  return launch_dequantize_general(q, s, out, r, b, stream);
}

}  // extern "C"
