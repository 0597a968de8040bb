// Hyper-block self-attention: softmax(Q K^T / sqrt(d_h)) V per hyper-block.
//
// Replaces the TPU kernel `_block_attn_kernel` / `block_attention_fwd`
// (src/repro/kernels/block_attention/kernel.py:27, :47).  As there, q, k, v
// are read in their own dtype (fp32 or bf16), scores, softmax and P.V are
// computed in fp32, and the output is written in the input's dtype.
//
// Shapes: q, k (B, n, dk), v (B, n, dv), contiguous.  n is the number of
// blocks in a hyper-block (10, 5 or 8 in the paper's S3D, E3SM and XGC
// configs) and d = 128.  Head h owns columns [h*d/heads, (h+1)*d/heads), as
// the reshape (tb, n, heads, d/heads) of the TPU kernel does.
//
// Bound on the H100: bytes.  A hyper-block reads 3*n*d values and writes
// n*d, and does about 4*n*n*d flops: at n = 10 that is 2.5 flops a byte in
// fp32, against the card's ~20 fp32 flops a byte.  The main path has two
// regimes:
//   * the compressor's stripes, (64, 10, 128): 1.3 MB, 0.4 us at 3.35 TB/s,
//     below the card's launch floor.  What bounds it is latency: one round
//     of loads and the chain of dependent steps after it.
//   * fit_basis's pass over the field, (1600, 10, 128) and 25 600
//     hyper-blocks at the paper's full S3D field: 33 and 524 MB.  What bounds
//     it is the bytes, if each input byte comes from device memory once and
//     enough bytes are in flight per SM (~25 KB at ~1 us of latency).  At
//     1600 hyper-blocks the inputs fit in the 50 MB L2, and the arithmetic
//     after the loads (shuffles, selects, expf, divisions) sets the time.
//
// Design (`block_attention_warp_kernel`): a warp owns a hyper-block, or
// `qpw` of its query rows when the batch is too small to fill the card, and
// keeps everything in registers: no shared memory and no block barrier.
//   * A lane owns VEC contiguous columns (16 bytes: 4 fp32 or 8 bf16), so a
//     row is lr = d / VEC lanes and a warp holds 32 / lr rows side by side
//     ("slots").  Key row j sits in slot j % slots.  Every load of the warp
//     (its Q rows, the K and V rows of its slot) is issued up front as a
//     16-byte load, neighbouring lanes on neighbouring addresses, and K and V
//     stay in registers (KPL rows a lane) for all the warp's queries.
//   * Scores: a lane's VEC-term partial dot per key, then a reduce-scatter
//     over the head's hl = lr / heads lanes (__shfl_xor_sync, segmented by
//     head): each step halves the partial sums a lane holds, so that after
//     K2 - 1 shuffles (KPL padded to a power of two K2) lane i of the head
//     holds the whole score of key i / (hl / K2).  That lane alone divides it
//     by sqrtf(d_h), takes expf of it and divides by the softmax's sum (max
//     and sum over the lanes by __shfl_xor_sync, then over the slots): one
//     score a lane, not every score in every lane.  P.V then takes each
//     weight from its lane by __shfl_sync and accumulates in fp32 in
//     registers; the slots' parts are summed, and one slot stores the row
//     with 16-byte stores straight from registers.  Query rows go in pairs,
//     two independent chains of shuffles for the scheduler to interleave.
//     Where a head has fewer lanes than K2 (many heads at a small d), every
//     lane of the head sums and finishes every score of its slot instead.
//   * d = 128 with one head (the paper's configs) has its own
//     instantiation, in which the lane layout is a constant: every
//     reduction unrolls, and fp32 has no slot reductions at all.
//   * The launch (`block_attention_warp`, with qpw chosen by the wrapper's
//     `launch_plan`) gives every hyper-block ceil(n / qpw) warps, two warps
//     to a block: at the B = 64 stripes a warp owns 2 query rows (320 warps
//     for the 132 SMs at n = 10); from B = 528 on a warp owns a whole
//     hyper-block and K and V are read once.  A warp holds at most QMAX
//     query rows, so that Q, K and V fit in registers without spills.
//   * No tensor cores: TF32 would break the 1e-5 fp32 parity with the plain
//     version, and the work is 2.5 flops a byte.
// The warp path takes fp32 and bf16 with dk == dv == d, d a multiple of VEC,
// d / VEC a power of two <= 32, d / heads a multiple of VEC,
// ceil(n / slots) <= 16 (fp32) or 8 (bf16), and 16-byte aligned pointers.
// That is every shape of the JAX kernel sweep and of the three configs.
//
// General path (`block_attention_general_kernel`, the first port's design):
// one thread block per hyper-block, Q, K, V and the (heads, n, n) scores in
// shared memory.  It takes only what the warp path cannot: dk != dv, d not a
// multiple of VEC, d / VEC not a power of two or above 32 (fp32 d = 96 or
// 256), d / heads below VEC or not a multiple of it, more key rows a lane
// than the warp path holds (n > 16 at fp32 d = 128), or misaligned pointers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 2;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int VEC = 4;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of a row: 4 fp32 or 8 bf16 (element 2i in the low half of word i)
__device__ __forceinline__ void unpack(uint4 u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                    __float_as_uint(x[2]), __float_as_uint(x[3]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint4 pack(const float (&x)[8]) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// 16-byte loads and stores, through the intrinsics so that they stay one
// 128-bit access each
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
template <typename T>
__device__ __forceinline__ void store16(T* p, uint4 x) {
  __stcg(reinterpret_cast<uint4*>(p), x);
}

// ---------------------------------------------------------------------------
// warp path
// ---------------------------------------------------------------------------

// Reduce-scatter of two rows of K2 partial sums over the hl lanes of a head
// (hl >= K2): each step halves the values a lane holds, the lane with `off`
// set keeping the upper half, until value 0 is key (lane % hl) / (hl / K2)
// summed over K2 lanes.  A template, so that every index is a constant and
// the values stay in registers.
template <int HALF, int K2>
__device__ __forceinline__ void reduce_scatter(float (&v)[2][K2], int hl,
                                               int lane) {
  if constexpr (HALF >= 1) {
    const int off = hl / (K2 / HALF);
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float send = up ? v[u][i] : v[u][i + HALF];
        const float keep = up ? v[u][i + HALF] : v[u][i];
        v[u][i] = keep + __shfl_xor_sync(kFull, send, off);
      }
    reduce_scatter<HALF / 2>(v, hl, lane);
  }
}

// D128: an instantiation for d = 128, heads = 1 (the paper's configs), in
// which the lane layout is a constant, every reduction loop unrolls and the
// slot reductions vanish (fp32) or take one step (bf16).
template <typename T, int KPL, int QMAX, bool D128>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_attention_warp_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            int batch, int n, int d, int heads, int qpw,
                            int wph) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int K2 = KPL <= 2 ? 2 : KPL <= 4 ? 4 : KPL <= 8 ? 8 : 16;
  static_assert(KPL <= 16 && QMAX % 2 == 0, "instantiation out of range");
  if (D128) {
    d = 128;
    heads = 1;
  }
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= batch * wph) return;  // batch * wph < 2^31: the launcher checks
  const int b = warp / wph;
  const int q0 = (warp - b * wph) * qpw;
  const int nq = min(qpw, n - q0);
  const int lr = d / VEC;        // lanes of one row
  const int slots = 32 / lr;     // rows side by side in the warp
  const int slot = lane / lr;
  const int col = (lane - slot * lr) * VEC;
  const int hl = lr / heads;     // lanes of one head
  const size_t base = (size_t)b * n * d + col;

  // every load up front: Q rows q0.., and the K, V rows of this lane's slot
  uint4 rq[QMAX], rk[KPL], rv[KPL];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int t = 0; t < QMAX; ++t)
    rq[t] = t < nq ? load16(q + base + (size_t)(q0 + t) * d) : zero;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int r = slot + j * slots;
    rk[j] = r < n ? load16(k + base + (size_t)r * d) : zero;
    rv[j] = r < n ? load16(v + base + (size_t)r * d) : zero;
  }
  float kf[KPL][VEC], vf[KPL][VEC];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    unpack(rk[j], kf[j]);
    unpack(rv[j], vf[j]);
  }
  const float scale = sqrtf((float)(d / heads));
  const int seg = lane & ~(hl - 1);  // the first lane of this lane's head

  if (hl >= K2) {
    // Scattered: after the reduce-scatter each lane finishes one score, so a
    // score is divided, exponentiated and normalised once, not in every
    // lane.  Two query rows at a time, for two independent chains.
    const int dup = hl / K2;           // lanes that finish the same key
    const int jl = (lane & (hl - 1)) / dup;
    const bool live = jl < KPL && slot + jl * slots < n;
#pragma unroll
    for (int t = 0; t < QMAX; t += 2) {
      if (t >= nq) break;  // warp-uniform; row t + 1 past nq is computed, not stored
      float v[2][K2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float qf[VEC];
        unpack(rq[t + u], qf);
#pragma unroll
        for (int j = 0; j < K2; ++j) {
          float a = 0.f;
          if (j < KPL) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) a = fmaf(qf[c], kf[j][c], a);
          }
          v[u][j] = a;
        }
      }
      reduce_scatter<K2 / 2>(v, hl, lane);
      float s[2], m[2], l[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int off = dup >> 1; off >= 1; off >>= 1)
          v[u][0] += __shfl_xor_sync(kFull, v[u][0], off);
        s[u] = live ? v[u][0] / scale : -INFINITY;
        m[u] = s[u];
      }
      // max and sum over the head's keys (lanes dup apart), then the slots
#pragma unroll
      for (int off = dup; off < hl; off <<= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          m[u] = fmaxf(m[u], __shfl_xor_sync(kFull, m[u], off));
#pragma unroll
      for (int off = lr; off < 32; off <<= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          m[u] = fmaxf(m[u], __shfl_xor_sync(kFull, m[u], off));
#pragma unroll
      for (int u = 0; u < 2; ++u) l[u] = s[u] = expf(s[u] - m[u]);  // 0 past n
#pragma unroll
      for (int off = dup; off < hl; off <<= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u) l[u] += __shfl_xor_sync(kFull, l[u], off);
#pragma unroll
      for (int off = lr; off < 32; off <<= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u) l[u] += __shfl_xor_sync(kFull, l[u], off);
      float acc[2][VEC];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[u] = s[u] / l[u];            // the weight of key jl
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[u][c] = 0.f;
      }
      // P.V: key j's weight from the lane that finished it
#pragma unroll
      for (int j = 0; j < KPL; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float w = __shfl_sync(kFull, s[u], seg + j * dup);
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[u][c] = fmaf(w, vf[j][c], acc[u][c]);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int off = lr; off < 32; off <<= 1)
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            acc[u][c] += __shfl_xor_sync(kFull, acc[u][c], off);
        if (t + u < nq && slot == (t + u) % slots)
          store16(o + base + (size_t)(q0 + t + u) * d, pack(acc[u]));
      }
    }
    return;
  }

  // Replicated: a head has fewer lanes than a lane has (padded) keys, so
  // every lane of the head finishes every score of its slot.  One query row
  // at a time.
#pragma unroll
  for (int t = 0; t < QMAX; ++t) {
    if (t >= nq) break;  // warp-uniform
    float qf[VEC];
    unpack(rq[t], qf);
    float s[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < VEC; ++c) a = fmaf(qf[c], kf[j][c], a);
      s[j] = a;
    }
    // the dot product over the head's columns: a sum over its hl lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off >= hl) break;
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[j] += __shfl_xor_sync(kFull, s[j], off);
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      s[j] = slot + j * slots < n ? s[j] / scale : -INFINITY;
      m = fmaxf(m, s[j]);
    }
    for (int off = lr; off < 32; off <<= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      s[j] = expf(s[j] - m);  // 0 for the keys past n
      l += s[j];
    }
    for (int off = lr; off < 32; off <<= 1)
      l += __shfl_xor_sync(kFull, l, off);
    float acc[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const float w = s[j] / l;
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] = fmaf(w, vf[j][c], acc[c]);
    }
    for (int off = lr; off < 32; off <<= 1)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        acc[c] += __shfl_xor_sync(kFull, acc[c], off);
    if (slot == t % slots)
      store16(o + base + (size_t)(q0 + t) * d, pack(acc));
  }
}

// SPEC: this (T, KPL) also has the D128 instantiation
template <typename T, int KPL, int QMAX, bool SPEC>
int launch_warp(const void* q, const void* k, const void* v, void* o,
                int batch, int n, int d, int heads, int qpw, int wph,
                cudaStream_t stream) {
  const long long warps = (long long)batch * wph;
  if (qpw < 1 || qpw > QMAX || wph < 1 || (long long)qpw * wph < n ||
      warps >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  bool launched = false;
  if constexpr (SPEC) {
    if (d == 128 && heads == 1) {
      block_attention_warp_kernel<T, KPL, QMAX, true>
          <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
              qt, kt, vt, ot, batch, n, d, heads, qpw, wph);
      launched = true;
    }
  }
  if (!launched)
    block_attention_warp_kernel<T, KPL, QMAX, false>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(qt, kt, vt, ot, batch, n,
                                                     d, heads, qpw, wph);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// general path
// ---------------------------------------------------------------------------

template <typename T>
__global__ void block_attention_general_kernel(const T* __restrict__ q,
                                               const T* __restrict__ k,
                                               const T* __restrict__ v,
                                               T* __restrict__ o, int n,
                                               int dk, int dv, int heads) {
  extern __shared__ float smem[];
  const int ldk = dk + 1, ldv = dv + 1;
  float* sq = smem;                    // (n, ldk)
  float* sk = sq + n * ldk;            // (n, ldk)
  float* sv = sk + n * ldk;            // (n, ldv)
  float* ss = sv + n * ldv;            // (heads, n, n) scores, then weights

  const long long b = blockIdx.x;
  const T* qb = q + b * n * dk;
  const T* kb = k + b * n * dk;
  const T* vb = v + b * n * dv;
  T* ob = o + b * n * dv;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < n * dk; e += nt) {
    int r = e / dk, c = e - r * dk;
    sq[r * ldk + c] = to_float(qb[e]);
    sk[r * ldk + c] = to_float(kb[e]);
  }
  for (int e = tid; e < n * dv; e += nt) {
    int r = e / dv, c = e - r * dv;
    sv[r * ldv + c] = to_float(vb[e]);
  }
  __syncthreads();

  const int dh = dk / heads, dhv = dv / heads;
  const float scale = sqrtf((float)dh);
  for (int e = tid; e < heads * n * n; e += nt) {
    int h = e / (n * n), rem = e - h * n * n;
    int i = rem / n, j = rem - i * n;
    const float* qi = sq + i * ldk + h * dh;
    const float* kj = sk + j * ldk + h * dh;
    float acc = 0.f;
    for (int c = 0; c < dh; ++c) acc = fmaf(qi[c], kj[c], acc);
    ss[e] = acc / scale;
  }
  __syncthreads();

  for (int row = tid; row < heads * n; row += nt) {
    float* s = ss + row * n;
    float m = s[0];
    for (int j = 1; j < n; ++j) m = fmaxf(m, s[j]);
    float sum = 0.f;
    for (int j = 0; j < n; ++j) {
      float w = expf(s[j] - m);
      s[j] = w;
      sum += w;
    }
    for (int j = 0; j < n; ++j) s[j] = s[j] / sum;
  }
  __syncthreads();

  for (int e = tid; e < n * dv; e += nt) {
    int i = e / dv, c = e - i * dv;
    int h = c / dhv;
    const float* w = ss + (h * n + i) * n;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(w[j], sv[j * ldv + c], acc);
    ob[e] = from_float<T>(acc);
  }
}

template <typename T>
int launch_general(const void* q, const void* k, const void* v, void* o,
                   int batch, int n, int dk, int dv, int heads,
                   cudaStream_t stream) {
  size_t smem = sizeof(float) *
                ((size_t)n * (dk + 1) * 2 + (size_t)n * (dv + 1) +
                 (size_t)heads * n * n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_attention_general_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_attention_general_kernel<T><<<batch, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, dk, dv, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  kpl is one of the instantiations below
// (keys a lane holds); qpw (query rows a warp owns, at most the
// instantiation's QMAX) and wph (warps a hyper-block) are chosen by the
// wrapper, `launch_plan` in kernels/block_attention/ops.py, which holds the
// same table.
extern "C" int block_attention_warp(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int batch, int n,
                                    int d, int heads, int kpl, int qpw,
                                    int wph, cudaStream_t stream) {
  if (batch <= 0) return (int)cudaGetLastError();
#define BA_CASE(T, KPL, QMAX, SPEC)                                     \
  if (kpl == KPL)                                                         \
    return launch_warp<T, KPL, QMAX, SPEC>(q, k, v, o, batch, n, d, heads, \
                                           qpw, wph, stream);
  if (dtype == 0) {
    BA_CASE(float, 2, 4, false)
    BA_CASE(float, 4, 8, false)
    BA_CASE(float, 5, 10, true)
    BA_CASE(float, 8, 10, true)
    BA_CASE(float, 10, 10, true)
    BA_CASE(float, 16, 8, false)
  } else if (dtype == 1) {
    BA_CASE(__nv_bfloat16, 2, 4, false)
    BA_CASE(__nv_bfloat16, 4, 8, true)
    BA_CASE(__nv_bfloat16, 5, 10, true)
    BA_CASE(__nv_bfloat16, 8, 8, false)
  }
#undef BA_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int block_attention_general(int dtype, const void* q,
                                       const void* k, const void* v, void* o,
                                       int batch, int n, int dk, int dv,
                                       int heads, cudaStream_t stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch_general<float>(q, k, v, o, batch, n, dk, dv, heads, stream);
  if (dtype == 1)
    return launch_general<__nv_bfloat16>(q, k, v, o, batch, n, dk, dv, heads,
                                         stream);
  return (int)cudaErrorInvalidValue;
}
