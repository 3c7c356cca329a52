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
//   Pallas kernel at :91) and computes what it computes: q pre-scaled by
//   1/sqrt(hd) (a division by the f32 sqrt(hd) from the caller), scores
//   and the running (m, l, acc) in f32, masked scores -1e30, the kv loop
//   stopping at the last tile that meets the q tile's causal triangle, the
//   output acc / max(l, 1e-20) cast to q's dtype (round to nearest even).
//
// Bound on the H100: at the serving path's prefill shape (B 8, S 1024,
// H 16, Hkv 8, hd 128, bf16) the causal FLOPs (4*B*H*hd*S(S+1)/2 = 34.4 G)
// over the tensor cores' dense bf16 peak take 0.035 ms, the bytes of q, k,
// v and o (101 MB) over HBM 0.030 ms.  This first kernel runs the two
// products on the CUDA cores in f32 (67 TFLOP/s peak), so it sits far
// above that bound; mma/wgmma, TMA and warp specialisation are later
// work.
//
// Design: one CTA of 256 threads per (64-row q tile, head, batch row); the
// causal grid walks the q tiles from the last (the longest kv loop) down,
// so the heavy CTAs start first.  The CTA stages its q tile (pre-scaled,
// f32, transposed to [d][row]) once, then for every 64-key kv tile stages
// k transposed ([d][key]) and v as it lies ([key][d]) in f32.  Thread
// (ty, tx) of the 16 x 16 grid owns rows 4ty..4ty+3 and, for the scores,
// keys 4tx..4tx+3: a 4 x 4 block of q.k sums over d from float4 reads of
// the two transposed tiles.  The row max and sum go across the 16 threads
// of a row group by shuffles.  p is written transposed over the k tile
// (k is spent by then) and the thread adds p v into its rows' output
// columns (hd / 16 of them, in chunks of 4 or 2 contiguous lanes).
// Shared memory: (hd + max(hd, 64)) * 68 + 64 * hd floats (100 KB at
// hd 128, so two CTAs share an SM).  Rows and keys past S (a ragged last
// tile) are staged as zeros, keys past S are masked like the causal ones,
// rows past S are not stored, so any S runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;         // q rows and kv keys per tile
constexpr int kPad = kTile + 4;   // stride of the transposed tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows of the k tile's region: hd for k ([d][key]), 64 for p ([key][row])
template <int HD>
__host__ __device__ constexpr int kp_rows() {
  return HD > kTile ? HD : kTile;
}

template <int HD>
constexpr size_t smem_bytes() {
  return ((HD + kp_rows<HD>()) * kPad + kTile * HD) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hkv, int causal, float sqrt_hd) {
  static_assert(HD % 32 == 0 && HD <= 128, "hd must be 32, 64 or 128");
  constexpr int NC = HD / 16;          // output columns per thread
  constexpr int VW = NC < 4 ? NC : 4;  // contiguous lanes per chunk
  constexpr int NCH = NC / VW;         // chunks per thread

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
  const T* qb = q + (static_cast<size_t>(b) * S) * q_row + h * HD;
  const T* kb = k + (static_cast<size_t>(b) * S) * kv_row + g * HD;
  const T* vb = v + (static_cast<size_t>(b) * S) * kv_row + g * HD;
  T* ob = o + (static_cast<size_t>(b) * S) * q_row + h * HD;

  for (int i = tid; i < kTile * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    qT[d * kPad + r] =
        row < S ? __fdiv_rn(to_f32(qb[row * q_row + d]), sqrt_hd) : 0.f;
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
      kT[d * kPad + c] = in ? to_f32(kb[key * kv_row + d]) : 0.f;
      vs[c * HD + d] = in ? to_f32(vb[key * kv_row + d]) : 0.f;
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
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vp);
          vv[0] = t.x; vv[1] = t.y;
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
        store(&ob[row * q_row + d], __fdiv_rn(acc[i][ch * VW + e], denom));
      }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int causal, float sqrt_hd, void* stream) {
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<HD>()));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem_bytes<HD>(),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, causal,
      sqrt_hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int hd, int causal, float sqrt_hd,
             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, Hkv, causal, sqrt_hd,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int Hkv, int hd, int causal,
                        float sqrt_hd, void* stream) {
  return dispatch<float>(q, k, v, o, B, S, H, Hkv, hd, causal, sqrt_hd,
                         stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int H, int Hkv, int hd,
                         int causal, float sqrt_hd, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd, causal,
                                 sqrt_hd, stream);
}

}  // extern "C"
