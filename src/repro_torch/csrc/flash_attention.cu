// Forward attention with online softmax: causal or not, optional sliding
// window, grouped-query heads, queries suffix-aligned to the end of the keys.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention_fwd`
// (src/repro/kernels/flash_attention/kernel.py:29, :89), reached through
// `ops.flash_attention` from `models/attention.py` `full_attention`.
//
// Layout: the model's own, q (B, S, H, hd) and k, v (B, T, KV, hd),
// contiguous.  Query head h reads kv head h / (H / KV) by index, so no
// repeated K/V exists in memory.  Query row i sits at absolute time
// i + (T - S).  Both kernels below compute what the TPU kernel computes:
// key tiles wholly beyond the causal limit or before the window are
// skipped; within a tile the mask sets the score to -1e30 and is multiplied
// into p, so a row with no live key in a tile adds nothing; the denominator
// is clamped at 1e-30, so a row that no key reaches (causal with S > T)
// comes out as zeros; keys past T and queries past S are masked in the
// loads (zero-filled), so no padded copy of the inputs exists.  Softmax runs
// in the log2 domain (scores pre-scaled by log2(e) / sqrt(hd), `exp2f`).
// The grid is one-dimensional and walks the query tiles from the last (the
// heaviest under a causal mask) to the first, and within a tile all heads
// of a batch row in order, so the H / KV query heads that share a kv head
// run side by side and read its K/V tiles from L2.
//
// What bounds them on the H100: operations.  At the qwen2-1.5b prefill
// shape (S = T = 4096, H = 12, hd = 128, causal) the live half of the score
// and context products is 4 * 12 * 4096^2 * 128 / 2 = 51.5 GFLOP against
// 50 to 100 MB moved (bf16, fp32), 500 to 1000 flops a byte.
//
// * bfloat16: `flash_fwd_bf16_wgmma_kernel`, on the tensor cores (roof
//   989 TFLOP/s).  One block per (b, h, 128-query tile) of two consumer
//   warpgroups (64 query rows each, `wgmma` m64) and one producer warp.
//   The producer brings Q once and K/V tiles of 64 keys into a ring of 4
//   stages by TMA (128-byte swizzle, the hardware zero-fills rows past S or
//   T and head columns past hd), with full/empty `mbarrier`s.  Each
//   consumer computes S = Q K^T by `wgmma` (bf16 in, fp32 accumulate, Q and
//   K from shared memory), the online softmax on the accumulator fragments
//   in registers (a row's max and sum across the 4 threads that hold it),
//   splits p in registers into two bf16 parts, hi = bf16(p) and
//   lo = bf16(p - hi), and feeds both as `wgmma`'s A operand from registers
//   for O += P_hi V + P_lo V, V read from shared memory through the
//   transposed-B mode.  (One bf16 P, as FlashAttention rounds it, is off by
//   up to 2^-9 of p, which a row with few live keys does not average away;
//   hi + lo keeps p to about 2^-17 for a third more tensor-core work.)  The
//   next tile's S and softmax run while the last tile's P V is on the
//   tensor cores.  O is scaled by 1/l, staged in
//   its own rows of the Q tile and stored as bf16 with 16-byte stores.
//   Every head size takes it: hd 16, 32, 48 and 64 run as 64 (the columns
//   past hd load as zeros and are not stored), hd 128 as 128.
// * float32: `flash_fwd_f32_kernel`, fp32 FMA (roof 67 TFLOP/s; TF32 would
//   break the fp32 parity).  One block of 128 threads per (b, h, 64-query
//   tile), K/V tiles of 128 keys.  A thread owns an 8 x 8 block of the
//   64 x 128 scores (rows 8*ty + i, keys tx + 16*j), read as float4 along hd
//   from rows padded by four floats (bank-free), 4 FMAs per float read from
//   shared memory; and 8 rows x hd/16 columns of the context accumulator,
//   fed by float4 reads of p and V, 4 FMAs per float.  K and V have one
//   buffer each and arrive by `cp.async` one tile ahead: the next K tile
//   loads while p and P V are computed, the next V tile while the next
//   scores are.  200 KB of shared memory a block at hd 128.
// Built with -O3 and no --use_fast_math.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// The tile a block owns: query tiles from the last to the first, heads of
// one batch row side by side.
struct TileIdx {
  int q0, h, b;
};

__device__ __forceinline__ TileIdx tile_of(int linear, int bq, int S, int H,
                                           int B) {
  const int nq = (S + bq - 1) / bq;
  const int h = linear % H, r = linear / H;
  return {(nq - 1 - r / B) * bq, h, r % B};
}

// Key tiles [lo, hi) of width bk that hold a live key for query rows
// [q0, q0 + bq) at absolute times q + off.
__device__ __forceinline__ void key_range(int q0, int bq, int S, int Tk,
                                          int off, int bk, int causal,
                                          int window, int* lo, int* hi) {
  const int q_first = q0 + off, q_last = min(q0 + bq, S) - 1 + off;
  int h_ = (Tk + bk - 1) / bk, l_ = 0;
  if (causal) h_ = q_last < 0 ? 0 : min(h_, q_last / bk + 1);
  if (window) {
    const int k_min = q_first - window + 1;    // first key any row can see
    l_ = k_min > 0 ? k_min / bk : 0;
  }
  *lo = l_;
  *hi = h_;
}

__device__ __forceinline__ bool live_key(int tq, int tk, int Tk, int causal,
                                         int window) {
  bool ok = tk < Tk;
  if (causal) ok = ok && tk <= tq;
  if (window) ok = ok && tq - tk < window;
  return ok;
}

// ===========================================================================
// float32: SIMT, 8 x 8 register tiles
// ===========================================================================
namespace simt {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 128;         // keys per tile
constexpr int NT = 128;         // threads per block, 8 (ty) x 16 (tx)
constexpr int LDP = BK + 4;     // row stride of the p tile

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// rows [r0, r0 + n) of a (len, stride) fp32 matrix into shared rows of `ld`
// floats; rows at or past `len` are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long stride, int r0, int n,
                                          int len) {
  constexpr int CH = HD / 4;      // 16-byte chunks a row
  for (int e = threadIdx.x; e < n * CH; e += NT) {
    const int r = e / CH, c = (e - r * CH) * 4;
    const bool ok = r0 + r < len;
    cp_async16(dst + r * ld + c, ok ? src + (r0 + r) * stride + c : src,
               ok ? 16 : 0);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * LDP);
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int Tk, int H, int KV, int B, int causal,
                     int window, float scale_log2) {
  constexpr int LD = HD + 4;      // row stride of the Q and K tiles
  constexpr int CPT = HD / 16;    // context columns per thread
  // hd 64 and 128: columns 4*tx + 64*c + e, read and written as float4;
  // hd 16, 32, 48: columns tx + 16*c
  constexpr bool VEC = HD % 64 == 0;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // (BQ, LD)
  float* sK = sQ + BQ * LD;                      // (BK, LD)
  float* sV = sK + BK * LD;                      // (BK, HD)
  float* sP = sV + BK * HD;                      // (BQ, LDP)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const TileIdx ti = tile_of(blockIdx.x, BQ, S, H, B);
  const int q0 = ti.q0, h = ti.h, b = ti.b;
  const int kvh = h / (H / KV);
  const int off = Tk - S;
  const long long qrow = (long long)H * HD, krow = (long long)KV * HD;
  const float* qb = q + (long long)b * S * qrow + (long long)h * HD;
  const float* kb = k + (long long)b * Tk * krow + (long long)kvh * HD;
  const float* vb = v + (long long)b * Tk * krow + (long long)kvh * HD;
  float* ob = o + (long long)b * S * qrow + (long long)h * HD;

  int j_lo, j_hi;
  key_range(q0, BQ, S, Tk, off, BK, causal, window, &j_lo, &j_hi);

  // commit groups, in order: Q + K_lo, V_lo, then per tile K_{j+1}, V_{j+1}
  // (empty past the last tile), so `wait_group 1` always leaves only the
  // newest one in flight
  load_rows<HD>(sQ, LD, qb, qrow, q0, BQ, S);
  if (j_lo < j_hi) load_rows<HD>(sK, LD, kb, krow, j_lo * BK, BK, Tk);
  cp_async_commit();
  if (j_lo < j_hi) load_rows<HD>(sV, HD, vb, krow, j_lo * BK, BK, Tk);
  cp_async_commit();

  float m_i[8], l_i[8], acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int jk = j_lo; jk < j_hi; ++jk) {
    const int k0 = jk * BK;
    cp_async_wait<1>();           // Q and this K tile have landed
    __syncthreads();

    float sc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 8 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bb =
            *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float s = sc[i][j];
          s = fmaf(a[i].x, bb.x, s);
          s = fmaf(a[i].y, bb.y, s);
          s = fmaf(a[i].z, bb.z, s);
          s = fmaf(a[i].w, bb.w, s);
          sc[i][j] = s;
        }
      }
    }
    __syncthreads();              // every thread is done with sK
    if (jk + 1 < j_hi) load_rows<HD>(sK, LD, kb, krow, k0 + BK, BK, Tk);
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int tq = q0 + ty * 8 + i + off;
      float live[8];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = live_key(tq, k0 + tx + 16 * j, Tk, causal, window);
        live[j] = ok ? 1.f : 0.f;
        sc[i][j] = ok ? sc[i][j] * scale_log2 : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      const float alpha = exp2f(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(sc[i][j] - m_new) * live[j];
        sP[(ty * 8 + i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
      l_i[i] = l_i[i] * alpha + row_sum16(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    cp_async_wait<1>();           // this V tile has landed
    __syncthreads();              // ... and every row of p is written

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&sP[(ty * 8 + i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
        const float* vr = sV + (kk + u) * HD;
        if constexpr (VEC) {
#pragma unroll
          for (int c = 0; c < CPT / 4; ++c) {
            const float4 t = *reinterpret_cast<const float4*>(
                vr + 4 * tx + 64 * c);
            vv[4 * c] = t.x;
            vv[4 * c + 1] = t.y;
            vv[4 * c + 2] = t.z;
            vv[4 * c + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c) vv[c] = vr[tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = lane_of(p4[i], u);
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();              // every thread is done with sV and sP
    if (jk + 1 < j_hi) load_rows<HD>(sV, HD, vb, krow, k0 + BK, BK, Tk);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = q0 + ty * 8 + i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    float* orow = ob + s * qrow;
    if constexpr (VEC) {
#pragma unroll
      for (int c = 0; c < CPT / 4; ++c)
        *reinterpret_cast<float4*>(orow + 4 * tx + 64 * c) =
            make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                        acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int H, int KV, int causal, int window,
           float scale_log2, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = ((S + BQ - 1) / BQ) * H * B;
  flash_fwd_f32_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, KV, B,
      causal, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ===========================================================================
// bfloat16: tensor cores (wgmma), TMA, warp-specialised
// ===========================================================================
namespace tc {

constexpr int BQ = 128;         // queries per block: two consumer warpgroups
constexpr int BK = 64;          // keys per tile
constexpr int STAGES = 4;       // K/V tiles in flight
constexpr int NT = 288;         // 2 consumer warpgroups + 1 producer warp
constexpr int ROW = 128;        // bytes of one swizzled row: 64 bf16

// A tile of `rows` x HDP bf16 is HDP / 64 column blocks of rows x 64, each
// block rows x 128 bytes in TMA's 128-byte swizzle (16-byte chunk c of row r
// at chunk c ^ (r % 8)), which is also `wgmma`'s 128B-swizzle layout.
template <int HDP>
struct Layout {
  static constexpr uint32_t Q_BYTES = BQ * HDP * 2;
  static constexpr uint32_t KV_BYTES = BK * HDP * 2;     // one K or V tile
  static constexpr uint32_t BARS = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr size_t SMEM = 1024 + BARS + 8 * (1 + 3 * STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarrier ---------------------------------------------------------------
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a wait
// of over 2^30 polls (far beyond any tile's load) traps, so a fault in the
// pipeline ends the launch with an error instead of hanging the card
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 30)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---- TMA: a 4-D box of a (B, len, heads, hd) bf16 tensor --------------------
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(b)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.  K-major operands (Q, K):
// stride 1024 bytes between 8-row groups, leading offset unused.  MN-major
// (V, read transposed): leading offset = the stride between 64-column
// blocks, stride offset = 1024 bytes between 8-key groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S (64 x 64, fp32) {+}= A (64 x 16, smem) . B^T (64 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128, fp32) += A (64 x 16, registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// byte offset of element (r, c) of a swizzled (rows, HDP) tile
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * ROW + r * ROW +
                    ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
}

template <int HDP>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o, int S, int Tk,
                            int H, int KV, int B, int hd, int causal,
                            int window, float scale_log2) {
  using L = Layout<HDP>;
  constexpr int NB = HDP / 64;         // 64-column blocks of a tile
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment, which the swizzle atoms need
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = base + L::Q_BYTES;
  const uint32_t sV = sK + STAGES * L::KV_BYTES;
  const uint32_t bars = base + L::BARS;
  const uint32_t q_full = bars;
  // k_full[s], v_full[s], empty[s]
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  const TileIdx ti = tile_of(blockIdx.x, BQ, S, H, B);
  const int q0 = ti.q0, h = ti.h, b = ti.b;
  const int kvh = h / (H / KV);
  const int off = Tk - S;
  int j_lo, j_hi;
  key_range(q0, BQ, S, Tk, off, BK, causal, window, &j_lo, &j_hi);
  const int nt = max(0, j_hi - j_lo);

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(k_full(s), 1);
      bar_init(v_full(s), 1);
      bar_init(empty(s), 8);           // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 8) {
    // ---- producer: one thread issues every TMA load ----
    if (lane == 0) {
      bar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load(sQ + c * BQ * ROW, &tm_q, q_full, 64 * c, h, q0, b);
      for (int it = 0; it < nt; ++it) {
        const int s = it % STAGES, use = it / STAGES;
        bar_wait(empty(s), (use & 1) ^ 1);   // the first use passes at once
        const int k0 = (j_lo + it) * BK;
        bar_expect_tx(k_full(s), L::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(sK + s * L::KV_BYTES + c * BK * ROW, &tm_k, k_full(s),
                   64 * c, kvh, k0, b);
        bar_expect_tx(v_full(s), L::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(sV + s * L::KV_BYTES + c * BK * ROW, &tm_v, v_full(s),
                   64 * c, kvh, k0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows [64 w, 64 w + 64) ----
  // Tile it's S = Q K^T and softmax run while tile it-1's O += P V is on
  // the tensor cores: issue S(it), issue PV(it-1), wait for S(it), softmax,
  // wait for PV(it-1), then rescale O and pack P(it).
  const int w = warp >> 2, wq = warp & 3;
  const int r0 = 16 * wq + (lane >> 2);          // this thread's rows r0, r0 + 8
  const int tq0 = q0 + 64 * w + r0 + off, tq1 = tq0 + 8;
  const int c_lane = 2 * (lane & 3);             // its first column of each 8

  float oacc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this thread's part
  float sc[BK / 2];
  // P of the tile awaiting its P V, as wgmma A fragments: p = hi + lo, both
  // bf16, so the product keeps p to about 2^-17 (one bf16 P would round it
  // by up to 2^-9, too much for a row with few live keys)
  uint32_t p_hi[BK / 4], p_lo[BK / 4];

  auto issue_s = [&](int it) {
    const uint32_t kt = sK + (it % STAGES) * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t a = sQ + (kk >> 2) * BQ * ROW + 64 * w * ROW + (kk & 3) * 32;
      const uint32_t bb = kt + (kk >> 2) * BK * ROW + (kk & 3) * 32;
      wgmma_ss_n64(sc, desc(a, 16, 1024), desc(bb, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int it) {
    const uint32_t vt = sV + (it % STAGES) * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // V's (keys, hd) tile read transposed: 16 keys a step
      const uint64_t dv = desc(vt + kk * 16 * ROW, BK * ROW, 1024);
      if constexpr (HDP == 128) {
        wgmma_rs_n128(oacc, p_hi + 4 * kk, dv);
        wgmma_rs_n128(oacc, p_lo + 4 * kk, dv);
      } else {
        wgmma_rs_n64(oacc, p_hi + 4 * kk, dv);
        wgmma_rs_n64(oacc, p_lo + 4 * kk, dv);
      }
    }
    wgmma_commit();
  };
  // after PV(it) completes: its A registers may be reused, its stage freed
  auto retire_pv = [&](int it) {
    fence_regs<HDP / 2>(oacc);
#pragma unroll
    for (int i = 0; i < BK / 4; ++i)
      asm volatile("" : "+r"(p_hi[i]), "+r"(p_lo[i])::"memory");
    __syncwarp();
    if (lane == 0) bar_arrive(empty(it % STAGES));
  };
  // online softmax of tile it on the fragments: sc[4 j + e] is row r0
  // (e < 2) or r0 + 8 (e >= 2), key k0 + 8 j + c_lane + (e & 1).  Leaves p
  // in sc and returns the rescale factors of the two rows.  A tile whose
  // every key is live for every row of this warpgroup (all but the tiles at
  // the causal diagonal, the window's edge or the ragged end) skips the mask.
  const int tq_lo = q0 + 64 * w + off;
  auto softmax = [&](int it, float* al0, float* al1) {
    const int k0 = (j_lo + it) * BK;
    const bool masked = k0 + BK > Tk || (causal && k0 + BK - 1 > tq_lo) ||
                        (window && tq_lo + 63 - k0 >= window);
    uint32_t live = 0xffffffffu;
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (masked) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tk = k0 + 8 * j + c_lane + (e & 1);
          if (!live_key(e < 2 ? tq0 : tq1, tk, Tk, causal, window)) {
            live &= ~(1u << (4 * j + e));
            sc[4 * j + e] = NEG_INF;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i & 3) < 2) mx0 = fmaxf(mx0, sc[i]); else mx1 = fmaxf(mx1, sc[i]);
    }
    // scale > 0, so the max of the scaled scores is the scaled max
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    *al0 = exp2f(m0 - mn0);
    *al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const bool r1 = (i & 3) >= 2;
      float p = exp2f(fmaf(sc[i], scale_log2, -(r1 ? mn1 : mn0)));
      if (masked) p = ((live >> i) & 1u) ? p : 0.f;
      sc[i] = p;
      if (r1) rs1 += p; else rs0 += p;
    }
    l0 = l0 * *al0 + rs0;
    l1 = l1 * *al1 + rs1;
  };
  // keep the A fragments and accumulators from being written past the
  // wgmma fence that precedes their use
  auto pin = [&]() {
    fence_regs<HDP / 2>(oacc);
#pragma unroll
    for (int i = 0; i < BK / 4; ++i)
      asm volatile("" : "+r"(p_hi[i]), "+r"(p_lo[i])::"memory");
  };
  auto rescale_and_pack = [&](float al0, float al1) {
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) oacc[i] *= ((i & 3) >= 2) ? al1 : al0;
    // k16 step kk takes keys 16 kk .. 16 kk + 15: the fragments' own layout
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float a = sc[2 * i], b = sc[2 * i + 1];
      const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
      p_hi[i] = pack_bf16(__bfloat162float(ha), __bfloat162float(hb));
      p_lo[i] = pack_bf16(a - __bfloat162float(ha), b - __bfloat162float(hb));
    }
  };

  bar_wait(q_full, 0);
  if (nt > 0) {
    float al0, al1;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    bar_wait(k_full(0), 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);
    softmax(0, &al0, &al1);
    rescale_and_pack(al0, al1);
    for (int it = 1; it < nt; ++it) {
      const int prev = it - 1;
      bar_wait(k_full(it % STAGES), (it / STAGES) & 1);
      pin();
      wgmma_fence();
      issue_s(it);
      bar_wait(v_full(prev % STAGES), (prev / STAGES) & 1);
      issue_pv(prev);
      wgmma_wait<1>();              // S(it) is done, PV(it-1) may not be
      fence_regs<BK / 2>(sc);
      softmax(it, &al0, &al1);
      wgmma_wait<0>();
      retire_pv(prev);
      rescale_and_pack(al0, al1);
    }
    const int last = nt - 1;
    bar_wait(v_full(last % STAGES), (last / STAGES) & 1);
    pin();
    wgmma_fence();
    issue_pv(last);
    wgmma_wait<0>();
    retire_pv(last);
  }

  // O / l, staged as bf16 in this warpgroup's own rows of the Q tile, then
  // stored with 16-byte stores; rows past S and columns past hd are dropped
  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const int ra = 64 * w + r0;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int c = 8 * j + c_lane;
    *reinterpret_cast<uint32_t*>(smem + swz(BQ, ra, c)) =
        pack_bf16(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(smem + swz(BQ, ra + 8, c)) =
        pack_bf16(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  const long long orow = (long long)H * hd;
  __nv_bfloat16* ob = o + (long long)b * S * orow + (long long)h * hd;
  const int t = threadIdx.x & 127;
  for (int idx = t; idx < 64 * (HDP / 8); idx += 128) {
    const int rr = idx / (HDP / 8), c = (idx % (HDP / 8)) * 8;
    const int srow = q0 + 64 * w + rr;
    if (srow < S && c < hd)
      *reinterpret_cast<int4*>(ob + srow * orow + c) =
          *reinterpret_cast<const int4*>(smem + swz(BQ, 64 * w + rr, c));
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, len, heads, hd) bf16 as a 4-D map, innermost first; boxes of 64 head
// columns x `rows` positions of one head, 128-byte swizzle, zero fill
// outside the tensor.  Returns 0 or a nonzero code.
int make_map(CUtensorMap* map, const void* ptr, int B, int len, int heads,
             int hd, int rows) {
  EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)len * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int H, int KV, int hd, int causal, int window,
           float scale_log2, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int st = make_map(&mq, q, B, S, H, hd, BQ);
  if (!st) st = make_map(&mk, k, B, Tk, KV, hd, BK);
  if (!st) st = make_map(&mv, v, B, Tk, KV, hd, BK);
  if (st) return st;
  const size_t smem = Layout<HDP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_wgmma_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = ((S + BQ - 1) / BQ) * H * B;
  flash_fwd_bf16_wgmma_kernel<HDP><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, Tk, H, KV, B, hd,
      causal, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns 0 when launched, a cudaError_t
// code, or 10000 + a CUresult when a TMA descriptor could not be made.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int S, int Tk, int H, int KV, int hd,
                                   int causal, int window,
                                   cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV) {
    return (int)cudaErrorInvalidValue;
  }
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  if (dtype == 0) {
    switch (hd) {
      case 16: return simt::launch<16>(q, k, v, o, B, S, Tk, H, KV, causal, window, scale_log2, stream);
      case 32: return simt::launch<32>(q, k, v, o, B, S, Tk, H, KV, causal, window, scale_log2, stream);
      case 48: return simt::launch<48>(q, k, v, o, B, S, Tk, H, KV, causal, window, scale_log2, stream);
      case 64: return simt::launch<64>(q, k, v, o, B, S, Tk, H, KV, causal, window, scale_log2, stream);
      case 128: return simt::launch<128>(q, k, v, o, B, S, Tk, H, KV, causal, window, scale_log2, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (hd) {
      case 16: case 32: case 48: case 64:
        return tc::launch<64>(q, k, v, o, B, S, Tk, H, KV, hd, causal, window, scale_log2, stream);
      case 128:
        return tc::launch<128>(q, k, v, o, B, S, Tk, H, KV, hd, causal, window, scale_log2, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
