// Causal or non-causal GQA attention forward with an online softmax, for
// Hopper (sm_90a), bound with ctypes through a plain C interface (see
// kernels/build.py and kernels/flash_attention.py).
//
//   flash_attention_{f32,bf16}
//     q (B, S, H, hd), k and v (B, S, Hkv, hd), all f32 or all bf16,
//     contiguous -> o (B, S, H, hd) of q's dtype:
//     o[b, i, h] = sum_j softmax_j(q_i . k_j / sqrt(hd)) v_j over the keys
//     j <= i (causal) or all j, kv head g = h / (H / Hkv) read in place.
//   Replaces src/repro/kernels/flash_attention.py flash_attention (the
//   Pallas kernel at :91) and computes what it computes: scores and the
//   running (m, l, acc) in f32, masked scores -1e30, the kv loop stopping
//   at the last tile that meets the q tile's causal triangle, the output
//   acc / max(l, 1e-20) cast to q's dtype (round to nearest even).
//
// Bound on the H100: at the serving path's prefill shape (B 8, S 1024,
// H 16, Hkv 8, hd 128, bf16) the causal FLOPs (4*B*H*hd*S(S+1)/2 = 34.4 G)
// over the tensor cores' dense bf16 peak take 0.035 ms, the bytes of q, k,
// v and o (101 MB) over HBM 0.030 ms: the products bound it.
//
// flash_attention_bf16 runs flash_fwd_wgmma_kernel, the products on the
// tensor cores:
//   * S = Q K^T by wgmma m64n64k16 (bf16 in, f32 accumulate), Q and K read
//     from shared memory, both K-major; the f32 scores are scaled by
//     log2(e) / sqrt(hd) (from the caller's f32 sqrt(hd)) and the softmax
//     runs in base 2, which moves p by a few f32 ulp, not a bf16 step.
//   * O += P V with p kept at f32 precision: p = p_hi + p_lo, both bf16
//     (p_hi = bf16_rn(p), p_lo = bf16_rn(p - p_hi), about 2^-16 relative
//     left), two wgmma m64nNk16 into the same f32 accumulator with A from
//     registers (the S accumulator's fragment is the A operand's layout)
//     and V read MN-major (the descriptor's transpose bit).  Rounding p to
//     bf16 alone would move about 40 % of the bf16 output lanes at the
//     prefill shape; the split moves well under 1 %.  It costs a third
//     more tensor work: 51.6 GFLOP issued for the 34.4 counted.
//   * One CTA per (q tile, pair of q heads or pair of 64-row tiles, batch
//     row): two consumer warpgroups of 64 q rows each share every K / V
//     tile.  When H / Hkv is even the two warpgroups take two heads of
//     one kv group (qwen3's 2:1 loads each K / V tile once for both);
//     otherwise they take 128 rows of one head.
//   * One producer warp loads Q once and K / V tiles of 64 keys by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, the layout the wgmma
//     descriptors read) into a ring of kStages stages, guarded by full /
//     empty mbarriers, so the next tile lands while this one is
//     multiplied.  Rows and keys past S are zero-filled by TMA; keys past
//     S are masked like the causal ones, rows past S are not stored.
//     hd 32 runs as hd 64 with the upper 32 columns zero-filled and never
//     stored; hd 80 and 112 run as hd 128 the same way: Q, K and V in two
//     64-column panels, the second box reaching past hd and zero-filled by
//     TMA (the tensor map's inner extent is hd), Q K^T over the hd / 16
//     k-steps that hold data (5 or 7), P V at N = 128 over V's zero
//     columns (a third and an eighth of its tensor work wasted), the
//     columns past hd never stored.  The causal grid starts the q tiles with the longest kv
//     loops first.
//   Shared memory: (2 + 2 kStages) tiles of 64 x max(hd, 64) bf16 (96 KB at
//   hd 128), one CTA of 288 threads per SM (the 64 + 32 accumulator
//   registers of a thread need more than half the register file).
//
// flash_attention_f32 runs flash_fwd_simt_kernel on the CUDA cores (67
// TFLOP/s peak in f32): tensor cores would multiply in TF32, which keeps
// about three decimal digits, not f32's.  One CTA of 256 threads per
// (64-row q tile, head, batch row) stages its q tile (pre-scaled by
// 1/sqrt(hd), transposed to [d][row]) once, then for every 64-key kv tile
// stages k transposed ([d][key]) and v as it lies ([key][d]).  Thread
// (ty, tx) of the 16 x 16 grid owns rows 4ty..4ty+3 and, for the scores,
// keys 4tx..4tx+3: a 4 x 4 block of q.k sums over d from float4 reads of
// the two transposed tiles.  The row max and sum go across the 16 threads
// of a row group by shuffles.  p is written transposed over the k tile
// (k is spent by then) and the thread adds p v into its rows' output
// columns (hd / 16 of them, in chunks of 4 or 2 contiguous lanes).
// At hd 80 and 112 a thread owns 5 or 7 output columns, 16 lanes apart
// (one float a load), where hd 32 / 64 / 128 take chunks of 2 or 4
// contiguous lanes.
// Shared memory: (hd + max(hd, 64)) * 68 + 64 * hd floats (100 KB at
// hd 128, so two CTAs share an SM).  Rows and keys past S (a ragged last
// tile) are staged as zeros, keys past S are masked like the causal ones,
// rows past S are not stored, so any S runs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTile = 64;         // q rows and kv keys per tile
constexpr int kPad = kTile + 4;   // stride of the transposed tiles

// rows of the k tile's region: hd for k ([d][key]), 64 for p ([key][row])
template <int HD>
__host__ __device__ constexpr int kp_rows() {
  return HD > kTile ? HD : kTile;
}

template <int HD>
constexpr size_t smem_bytes() {
  return ((HD + kp_rows<HD>()) * kPad + kTile * HD) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int S, int H, int Hkv, int causal, float sqrt_hd) {
  static_assert(HD % 16 == 0 && HD <= 128, "hd a multiple of 16, <= 128");
  constexpr int NC = HD / 16;  // output columns per thread
  // contiguous lanes per chunk: 4 or 2 where they divide NC (hd 32, 64,
  // 128), else 1 (hd 80, 112: 5 or 7 columns a thread, 16 lanes apart)
  constexpr int VW = NC % 4 == 0 ? 4 : (NC % 2 == 0 ? 2 : 1);
  constexpr int NCH = NC / VW;  // chunks per thread

  extern __shared__ float smem[];
  float* qT = smem;                       // [HD][kPad]: q, pre-scaled
  float* kT = qT + HD * kPad;             // [HD][kPad]: k; later p
  float* vs = kT + kp_rows<HD>() * kPad;  // [kTile][HD]: v

  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qt * kTile;

  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(Hkv) * HD;
  const float* qb = q + (static_cast<size_t>(b) * S) * q_row + h * HD;
  const float* kb = k + (static_cast<size_t>(b) * S) * kv_row + g * HD;
  const float* vb = v + (static_cast<size_t>(b) * S) * kv_row + g * HD;
  float* ob = o + (static_cast<size_t>(b) * S) * q_row + h * HD;

  for (int i = tid; i < kTile * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    qT[d * kPad + r] =
        row < S ? __fdiv_rn(qb[row * q_row + d], sqrt_hd) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (S + kTile - 1) / kTile;
  // the last kv tile meeting this q tile's causal triangle (+1)
  const int n_live = causal ? min(qt + 1, n_kt) : n_kt;
  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's p and v are spent
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int key = k0 + c;
      const bool in = key < S;
      kT[d * kPad + c] = in ? kb[key * kv_row + d] : 0.f;
      vs[c * HD + d] = in ? vb[key * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * kPad + 4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&kT[d * kPad + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * tx + j;
        if (key >= S || (causal && key > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread's scores are read: k is spent
    float* pT = kT;   // [kTile keys][kPad rows]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&pT[(4 * tx + j) * kPad + 4 * ty]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&pT[c * kPad + 4 * ty]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const float* vp = &vs[c * HD + ch * 16 * VW + tx * VW];
        float vv[VW];
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vp);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else if constexpr (VW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(vp);
          vv[0] = t.x; vv[1] = t.y;
        } else {
          vv[0] = *vp;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][ch * VW + e] = fmaf(pv[i], vv[e], acc[i][ch * VW + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = ch * 16 * VW + tx * VW + e;
        ob[row * q_row + d] = __fdiv_rn(acc[i][ch * VW + e], denom);
      }
  }
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int Hkv, int causal, float sqrt_hd,
                void* stream) {
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_simt_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<HD>()));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_fwd_simt_kernel<HD><<<grid, kThreads, smem_bytes<HD>(),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, causal,
      sqrt_hd);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kRows = 64;               // q rows of a consumer warpgroup
constexpr int kKeys = 64;               // keys of a kv tile
constexpr int kPanelCols = 64;          // bf16 columns of a 128-byte row
constexpr int kPanelBytes = 64 * 128;   // one [64][64] bf16 panel
constexpr int kSwizzleAtom = 8 * 128;   // 8 rows of 128 bytes
constexpr int kStages = 2;              // K / V ring depth
constexpr int kConsumers = 256;         // two warpgroups
constexpr int kThreadsTC = kConsumers + 32;  // and the producer warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One [64][64] bf16 box of a (dim0, dim1, dim2, dim3) tensor map at the
// given coordinates into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at ``addr``
// (1024-byte aligned, plus a k offset inside the swizzle row): start
// address, leading and stride byte offsets (in 16-byte units), layout 1
// (SWIZZLE_128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of a wgmma's registers
// across the asynchronous product (it cannot see that the asm returns
// before the product lands).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) * B (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// CTA work: blockIdx.x = (q tile from the heaviest, batch row, slot); in
// ``pair`` mode slot s holds q heads 2s and 2s+1 (one per warpgroup, the
// same kv head) over 64 rows, otherwise q head s over 128 rows (64 per
// warpgroup).
template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int B, int S, int H,
                       int group, int causal, float scale_log2, int pair,
                       int n_qt, int n_slots) {
  static_assert(HD == 32 || HD == 64 || HD == 80 || HD == 112 || HD == 128,
                "hd 32, 64, 80, 112 or 128");
  constexpr int NP = (HD + kPanelCols - 1) / kPanelCols;  // panels per row
  constexpr int N = NP * kPanelCols;   // head dim on the tensor cores
  constexpr int TILE = NP * kPanelBytes;  // one [64][N] bf16 tile
  constexpr int NK = HD / 16;          // k steps of Q K^T

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 3 * kStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* sq = smem;                    // [2][TILE]: one per warpgroup
  uint8_t* sk = sq + 2 * TILE;           // [kStages][TILE]
  uint8_t* sv = sk + kStages * TILE;     // [kStages][TILE]
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int per_qt = n_slots * B;
  const int qi = blockIdx.x / per_qt;
  const int rem = blockIdx.x - qi * per_qt;
  const int b = rem / n_slots;
  const int slot = rem - b * n_slots;
  const int qt = causal ? n_qt - 1 - qi : qi;
  const int rows_cta = pair ? kRows : 2 * kRows;
  const int q0 = qt * rows_cta;
  const int g = (pair ? 2 * slot : slot) / group;
  const int last_row = min(q0 + rows_cta, S) - 1;
  // the last kv tile meeting this CTA's causal triangle (+1)
  const int n_live = causal ? last_row / kKeys + 1 : (S + kKeys - 1) / kKeys;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one lane issues every copy
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, 2 * TILE);
      for (int w = 0; w < 2; ++w)
        for (int p = 0; p < NP; ++p)
          tma_load(sq + w * TILE + p * kPanelBytes, &tm_q, q_full,
                   p * kPanelCols, pair ? 2 * slot + w : slot,
                   pair ? q0 : q0 + w * kRows, b);
      for (int j = 0; j < n_live; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_expect_tx(&k_full[s], TILE);
        for (int p = 0; p < NP; ++p)
          tma_load(sk + s * TILE + p * kPanelBytes, &tm_k, &k_full[s],
                   p * kPanelCols, g, j * kKeys, b);
        mbar_expect_tx(&v_full[s], TILE);
        for (int p = 0; p < NP; ++p)
          tma_load(sv + s * TILE + p * kPanelBytes, &tm_v, &v_full[s],
                   p * kPanelCols, g, j * kKeys, b);
      }
    }
    return;
  }

  // consumers: warpgroup w, warp wp of it, lane; this thread's rows are
  // r_lo and r_lo + 8, its columns 8c + 2 (lane % 4) + {0, 1} for c < N/8
  const int w = tid / 128;
  const int wp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int h = pair ? 2 * slot + w : slot;
  const int row0 = (pair ? q0 : q0 + w * kRows) + 16 * wp;  // the warp's
  const int r_lo = row0 + lane / 4;
  const int c_lo = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(sq + w * TILE);

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_live; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t k_addr = smem_u32(sk + s * TILE);
    const uint32_t v_addr = smem_u32(sv + s * TILE);
    const int k0 = j * kKeys;

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(&k_full[s], parity);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss_n64(sc, smem_desc(q_addr + off, 16, kSwizzleAtom),
                   smem_desc(k_addr + off, 16, kSwizzleAtom), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in base 2; mask keys past S and past the row (causal) where
    // this warp's rows meet them
    const bool edge = k0 + kKeys > S || (causal && k0 + kKeys - 1 > row0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float t = sc[i] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * (i / 4) + c_lo + (i % 2);
        const int row = r_lo + 8 * ((i / 2) % 2);
        if (key >= S || (causal && key > row)) t = kNegInf;
      }
      sc[i] = t;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], t);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2f(sc[i] - m[(i / 2) % 2]);
      l[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // p = p_hi + p_lo in bf16 pairs: A fragments of the four 16-key steps
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        p_hi[kk][e] = bf16x2_bits(hi);
        p_lo[kk][e] = bf16x2_bits(__floats2bfloat162_rn(
            x0 - __low2float(hi), x1 - __high2float(hi)));
      }

    mbar_wait(&v_full[s], parity);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(p_hi[kk]);
      fence_regs(p_lo[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // keys 16kk..16kk+15: two 8-key swizzle atoms; the 64-column panels
      // of V sit kPanelBytes apart
      const uint64_t dv =
          smem_desc(v_addr + kk * 2 * kSwizzleAtom, kPanelBytes, kSwizzleAtom);
      wgmma_rs<N>(acc, p_hi[kk], dv);
      wgmma_rs<N>(acc, p_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(p_hi[kk]);
      fence_regs(p_lo[kk]);
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);
  }
  const size_t q_row = static_cast<size_t>(H) * HD;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * S * q_row + h * HD;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int col = 8 * (i / 4) + c_lo;
    const int r = (i / 2) % 2;
    const int row = r_lo + 8 * r;
    if (8 * (i / 4) < HD && row < S) {
      *reinterpret_cast<__nv_bfloat162*>(&ob[row * q_row + col]) =
          __floats2bfloat162_rn(__fdiv_rn(acc[i], l[r]),
                                __fdiv_rn(acc[i + 1], l[r]));
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (nothing linked).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Nonzero return codes of the bf16 launch beyond cudaError_t's: a tensor
// map refused (kTensorMapError + its CUresult) or no entry point.
constexpr int kTensorMapError = 10000;

// The (hd, heads, S, B) view of a contiguous (B, S, heads, hd) bf16 tensor,
// read in [64 rows][64 columns] boxes, 128-byte swizzled, zero-filled
// past every edge.
int encode(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
           int B) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kTensorMapError;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {hd * e, heads * hd * e,
                                 static_cast<cuuint64_t>(S) * heads * hd * e};
  const cuuint32_t box[4] = {kPanelCols, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int B, int S, int H, int Hkv, int causal, float sqrt_hd,
                 void* stream) {
  constexpr int NP = (HD + kPanelCols - 1) / kPanelCols;
  constexpr size_t smem = (2 + 2 * kStages) * NP * kPanelBytes + 1024;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, HD, H, S, B);
  if (rc == 0) rc = encode(&tk, k, HD, Hkv, S, B);
  if (rc == 0) rc = encode(&tv, v, HD, Hkv, S, B);
  if (rc != 0) return rc;
  const int group = H / Hkv;
  const int pair = group % 2 == 0;
  const int rows_cta = pair ? kRows : 2 * kRows;
  const int n_qt = (S + rows_cta - 1) / rows_cta;
  const int n_slots = pair ? H / 2 : H;
  const long long blocks = static_cast<long long>(n_qt) * n_slots * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / static_cast<double>(sqrt_hd));
  flash_fwd_wgmma_kernel<HD><<<static_cast<unsigned>(blocks), kThreadsTC,
                               smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, H, group, causal,
      scale_log2, pair, n_qt, n_slots);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int B, int S, int H, int Hkv) {
  return B > 0 && S > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 &&
         H <= 65535 && B <= 65535;
}

}  // namespace

extern "C" {

// Each returns 0 when launched, else cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a shape the kernel does not take, or (bf16)
// 10000 + the CUresult of a refused tensor map (10000: no driver entry).

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int Hkv, int hd, int causal,
                        float sqrt_hd, void* stream) {
  if (!valid(B, S, H, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch_simt<32>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                             stream);
    case 64:
      return launch_simt<64>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                             stream);
    case 80:
      return launch_simt<80>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                              stream);
    case 112:
      return launch_simt<112>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                               stream);
    case 128:
      return launch_simt<128>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                              stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int H, int Hkv, int hd,
                         int causal, float sqrt_hd, void* stream) {
  if (!valid(B, S, H, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch_wgmma<32>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                              stream);
    case 64:
      return launch_wgmma<64>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                              stream);
    case 80:
      return launch_wgmma<80>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                              stream);
    case 112:
      return launch_wgmma<112>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                               stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
