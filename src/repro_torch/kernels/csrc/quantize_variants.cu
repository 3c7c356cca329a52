// Other designs of quantize.cu's quantize_int8, built and timed only by
// ``repro_torch/kernels/hold_timing.py`` (and, the parent, timed beside
// the package's kernel by ``chip_smoke.py`` phase 4); no wrapper of the
// package calls them.  Each takes the package's quantize_int8 arguments
// and gives its bits.
//
//   quantize_int8_general
//                        the kernel's first design, as it stood for every
//                        shape (quantize_int8_kernel, included from
//                        quantize.cu): one warp a row, a strided running
//                        absmax over 16 4-byte loads a lane, then the row
//                        read again and stored a byte at a time
//   quantize_int8_g<G>_r<RW>_t<T>
//                        the package's B = 512 kernel
//                        (quantize_int8_b512_kernel) with G lanes a row
//                        (32: a warp, 4 float4 a lane; 16: a half-warp,
//                        8 float4 a lane), RW rows a lane group in turn (1
//                        or 2) and blocks of T threads (128 or 256); only
//                        where the package's kernel would run (B = 512,
//                        x 16- and q 4-byte aligned), else it returns -1
//
// and of its dequantize_int8, with the package's dequantize_int8
// arguments and bits:
//
//   dequantize_int8_general
//                        the kernel's first design, as it stood for every
//                        shape (dequantize_int8_kernel): one block of 256
//                        a row, a level a thread at a time, read a byte
//                        and converted with I2F, stored as one float
//   dequantize_int8_g<G>_r<RW>_t<T>
//                        the package's B = 512 kernel
//                        (dequantize_int8_b512_kernel) with G lanes a row
//                        (32: 4 words a lane; 16: 8), RW rows a lane group
//                        (1 or 2) and blocks of T threads (128 or 256);
//                        only where the package's kernel would run (B =
//                        512, q 4- and out 16-byte aligned), else -1

#include "quantize.cu"

extern "C" {

int quantize_int8_general(const void* x, void* q, void* s, int64_t r,
                          int64_t b, float inv, void* stream) {
  return launch_quantize_general(x, q, s, r, b, inv, stream);
}

#define QUANT_VARIANT(G, RW, T)                                             \
  int quantize_int8_g##G##_r##RW##_t##T(const void* x, void* q, void* s,    \
                                        int64_t r, int64_t b, float inv,    \
                                        void* stream) {                     \
    if (!quantize_b512_ok(x, q, b)) return -1;                              \
    return launch_quantize_b512<G, RW, T>(x, q, s, r, inv, stream);         \
  }

QUANT_VARIANT(32, 1, 128)
QUANT_VARIANT(32, 1, 256)
QUANT_VARIANT(32, 2, 128)
QUANT_VARIANT(32, 2, 256)
QUANT_VARIANT(16, 1, 128)
QUANT_VARIANT(16, 1, 256)

int dequantize_int8_general(const void* q, const void* s, void* out,
                            int64_t r, int64_t b, void* stream) {
  return launch_dequantize_general(q, s, out, r, b, stream);
}

#define DEQUANT_VARIANT(G, RW, T)                                           \
  int dequantize_int8_g##G##_r##RW##_t##T(const void* q, const void* s,     \
                                          void* out, int64_t r, int64_t b,  \
                                          void* stream) {                   \
    if (!dequantize_b512_ok(q, out, b)) return -1;                          \
    return launch_dequantize_b512<G, RW, T>(q, s, out, r, stream);          \
  }

DEQUANT_VARIANT(32, 1, 128)
DEQUANT_VARIANT(32, 1, 256)
DEQUANT_VARIANT(32, 2, 128)
DEQUANT_VARIANT(32, 2, 256)
DEQUANT_VARIANT(16, 1, 128)
DEQUANT_VARIANT(16, 1, 256)

}  // extern "C"
