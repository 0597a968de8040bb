// Forward attention with online softmax: causal or not, optional sliding
// window, grouped-query heads, queries suffix-aligned to the end of the keys.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention_fwd`
// (src/repro/kernels/flash_attention/kernel.py:29, :89), reached through
// `ops.flash_attention` from `models/attention.py` `full_attention`.
//
// Layout: the model's own, q (B, S, H, hd) and k, v (B, T, KV, hd),
// contiguous, fp32 or bf16 (a template on the element type); all arithmetic
// in fp32.  Query head h reads kv head h / (H / KV) by index, so no repeated
// K/V exists in memory.  Query row i sits at absolute time i + (T - S).
//
// Bound on the H100: operations.  At the qwen2-1.5b prefill shape (S = T =
// 4096, H = 12, hd = 128, causal) the live half of the score and context
// products is 4 * 12 * 4096^2 * 128 / 2 = 51.5 GFLOP against 113 MB moved:
// 450 flops a byte.  This first kernel uses fp32 FMA, not tensor cores, so
// its roof is the 67 TFLOP/s fp32 rate; the design keeps every operand of
// the two products in shared memory and registers:
//   * one thread block of 256 threads per (b, h, 64-query tile); the grid
//     is (ceil(S/64), H, B);
//   * the Q tile stays in shared memory; K and V tiles of 64 keys stream
//     through it, loaded with the ragged end (t >= T) masked to zero, so no
//     padded copy of the inputs exists;
//   * each thread owns a 4 x 4 block of the 64 x 64 scores (rows 4*ty + i,
//     columns tx + 16*j), read as float4 along hd from rows padded by four
//     floats so that the reads hit distinct banks; the row max and sum of
//     the online softmax are reduced across the 16 threads of a row by warp
//     shuffles, and p goes through shared memory to the P.V product;
//   * each thread keeps the fp32 accumulator of its 4 rows x hd/16 columns
//     in registers, rescaled by alpha = exp(m_old - m_new) per key tile;
//   * key tiles wholly beyond the causal limit or before the window are
//     skipped; within a tile the mask is applied to the scores (-1e30) and
//     multiplied into p, so a row with no live key in a tile adds nothing,
//     and the denominator is clamped at 1e-30, as in the TPU kernel: a row
//     that no key reaches (causal with S > T) comes out as zeros.
// Shared memory at hd = 128: 115 KB a block.  Built with -O3 and no
// --use_fast_math: `expf` is the accurate one.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads per block, 16 x 16
constexpr int LDP = BK + 4;     // row stride of the p tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);     // round to nearest even, as torch's cast
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * LDP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int H, int KV, int causal, int window, float scale) {
  constexpr int LD = HD + 4;      // row stride of the Q and K tiles
  constexpr int CPT = HD / 16;    // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // (BQ, LD)
  float* sK = sQ + BQ * LD;                      // (BK, LD)
  float* sV = sK + BK * LD;                      // (BK, HD)
  float* sP = sV + BK * HD;                      // (BQ, LDP)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Tk - S;
  const long long qrow = (long long)H * HD, krow = (long long)KV * HD;
  const T* qb = q + (long long)b * S * qrow + (long long)h * HD;
  const T* kb = k + (long long)b * Tk * krow + (long long)kvh * HD;
  const T* vb = v + (long long)b * Tk * krow + (long long)kvh * HD;
  T* ob = o + (long long)b * S * qrow + (long long)h * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, c = e - r * HD, s = q0 + r;
    sQ[r * LD + c] = s < S ? to_f(qb[s * qrow + c]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // absolute times of this tile's first and last (padded) query rows
  const int q_first = q0 + off, q_last = q0 + BQ - 1 + off;
  const int nk = (Tk + BK - 1) / BK;
  for (int jk = 0; jk < nk; ++jk) {
    const int k0 = jk * BK;
    if (causal && k0 > q_last) break;                       // beyond the limit
    if (window && k0 + BK - 1 <= q_first - window) continue;  // before window
    __syncthreads();      // the previous tile's readers of sK, sV, sP are done
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, c = e - r * HD, t = k0 + r;
      const bool ok = t < Tk;
      sK[r * LD + c] = ok ? to_f(kb[t * krow + c]) : 0.f;
      sV[r * HD + c] = ok ? to_f(vb[t * krow + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bb[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = sc[i][j];
          s = fmaf(a[i].x, bb[j].x, s);
          s = fmaf(a[i].y, bb[j].y, s);
          s = fmaf(a[i].z, bb[j].z, s);
          s = fmaf(a[i].w, bb[j].w, s);
          sc[i][j] = s;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tq = q0 + ty * 4 + i + off;
      float live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tk = k0 + tx + 16 * j;
        bool ok = tk < Tk;
        if (causal) ok = ok && tk <= tq;
        if (window) ok = ok && tq - tk < window;
        live[j] = ok ? 1.f : 0.f;
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new) * live[j];
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
      l_i[i] = l_i[i] * alpha + row_sum16(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&sP[(ty * 4 + i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = sV[(kk + u) * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y
                        : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[s * qrow + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = (float)(1.0 / sqrt((double)HD));
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KV, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Tk, int H, int KV, int hd, int causal, int window,
             cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tk, H, KV, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tk, H, KV, causal, window, stream);
    case 48: return launch<T, 48>(q, k, v, o, B, S, Tk, H, KV, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, KV, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tk, H, KV, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int S, int Tk, int H, int KV, int hd,
                                   int causal, int window,
                                   cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, Tk, H, KV, hd, causal, window,
                           stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, Tk, H, KV, hd, causal,
                                   window, stream);
  return (int)cudaErrorInvalidValue;
}
