// Mamba-2 chunked SSD scan:
//   y_s = sum_{t<=s} (C_s . B_t) exp(cum_s - cum_t) dt_t x_t,
// with per-head scalar decay A = -exp(a_log), chunked into blocks of Q steps
// with an fp32 (P, N) state carried from chunk to chunk.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_fwd`
// (src/repro/kernels/ssd_scan/kernel.py:32, :79), reached through `ops.ssd`
// from `models/ssd.py` `_block_forward`.
//
// Shapes: x (B, S, H, P), dt (B, S, H), a_log (H,), b and c (B, S, G, N),
// all fp32 and contiguous; head h reads group h / (H / G).  Outputs y
// (B, S, H, P) and the final state (B, H, P, N), fp32.  N <= 128.
//
// Bound on the H100: operations.  At the mamba2-370m shape (S = 4096, H = 32,
// P = 64, N = 128, Q = 256) the products of the chunked algorithm (the causal
// half of C.B^T once per group; per head the causal half of scores.x, C.h
// and the state update) are 6.6 GFLOP a call against 70 MB moved.
//
// The TPU kernel runs one program per (b, h) and walks the chunks in order,
// the state in VMEM.  Walking the chunks in order is what held the first
// port back: 128 blocks for 132 SMs, each a chain of loads and barriers per
// chunk with nothing else in flight, and every chunk's C, B and C.B^T re-read
// by every block.  Here the chunks are independent except for one
// elementwise recurrence, the chunk-parallel form of SSD, in four kernels on
// one stream (one launch of the op):
//   1. `ssd_cb_kernel`, one block per (b, group, chunk, 64 x 64 tile on or
//      below the diagonal): C.B^T into a (B, G, nc, Q, Q) scratch (4 MB at
//      mamba2-370m, read back from L2 by the group's heads);
//   2. `ssd_chunk_state_kernel`, one block per (b, h, chunk, 64 columns of
//      P): cum = cumsum(dt a) over the chunk as a block-wide scan, into a
//      (B, nc, Q, H) scratch, and the chunk's own state
//      s_c = sum_t exp(cum_last - cum_t) dt_t x_t b_t^T, into a
//      (B, nc, H, N, P) scratch (16 MB at mamba2-370m, which stays in L2);
//   3. `ssd_state_passing_kernel`, one thread per (b, h, n, p): walks the
//      chunks, h_in[c] = carry; carry = exp(cum_last[c]) carry + s_c,
//      writing h_in into a (B, nc, H, N, P) scratch and the last carry to
//      `state`;
//   4. `ssd_chunk_scan_kernel`, one block per (b, h, chunk, 64 rows of the
//      chunk, 64 columns of P): y = exp(cum_s) C_s . h_in[c] +
//      (C.B^T * exp(cum_s - cum_t) dt_t [t <= s]) . x, over the 64-row tiles
//      of t on or below the diagonal.  Heavy tiles (near the end of the
//      chunk) are scheduled first.
// At mamba2-370m that is 160 + 512 + 1024 + 2048 blocks instead of 128.
// Phases 2 and 4 are register-tiled SIMT fp32 GEMMs (8 x 4 and 4 x 4 outputs
// a thread, read 16 bytes at a time) from shared memory; their operand tiles arrive by `cp.async`,
// with the next tile's copy in flight while this tile's FMAs run.  fp32 FMA
// only, no tensor cores: the kernel is held to its fp32 plain version, and
// the gap to the bound was parallelism and traffic, not the FMA rate.
// A ragged S is handled in the loads: positions at or beyond S read as
// dt = 0, x = b = c = 0 (`cp.async` zero-fills), which is exactly the padded
// call's input, so the final state is bit-identical to that of a call padded
// with dt = 0, and y rows beyond S are not written.
// Built with -O3 and no --use_fast_math: `expf` is the accurate one.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // threads per block, 16 x 16
constexpr int TS = 64;          // rows of a tile of the chunk, columns of P
constexpr int TK = 32;          // rows of t per step of the chunk state
constexpr int LDW = TS + 4;     // row stride of the scores tile
constexpr int NI = 8;           // rows n of the chunk state a thread holds:
                                // 16 x 8 covers N <= 128

struct Dims {
  int S, H, P, N, G, Q, nc;
  bool vec_bc, vec_x;   // rows of b, c (of x, y and the states) are
                        // 16-byte aligned float4 groups
};

__host__ __device__ inline int n4(int N) { return (N + 3) / 4 * 4; }
__host__ __device__ inline int ptiles(int P) { return (P + TS - 1) / TS; }
__host__ __device__ inline int qtiles(int Q) { return (Q + TS - 1) / TS; }

// ---- shared memory, in floats ---------------------------------------------
size_t cb_smem(int N) { return 2 * (size_t)TS * (n4(N) + 4); }
size_t state_smem(int Q) {
  return 3 * (size_t)Q + 8 + 2 * (size_t)TK * (TS + 16 * NI);
}
size_t scan_smem(int N, int Q) {
  const size_t a = (size_t)TS * (n4(N) + 4) + (size_t)n4(N) * TS;
  const size_t b = 2 * (size_t)TS * TS + (size_t)TS * LDW;
  return 2 * (size_t)Q + (a > b ? a : b);
}

// ---- cp.async with zero fill ----------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// A (rows, 4 * groups) tile of shared memory (row stride ld) from rows of a
// strided operand (row stride `stride` floats): element (r, col) is
// src[r * stride + col] where r < valid and col < width, else 0.  `vec`:
// width, stride and src are whole 16-byte groups.
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows,
                                          int groups, const float* src,
                                          long long stride, int valid,
                                          int width, bool vec) {
  for (int e = threadIdx.x; e < rows * groups; e += NT) {
    const int r = e / groups, col = (e - r * groups) * 4;
    float* d = dst + r * ld + col;
    const float* s = src + r * stride + col;
    if (vec) {
      const bool ok = r < valid && col < width;
      cp_async16(d, ok ? s : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = r < valid && col + q < width;
        cp_async4(d + q, ok ? s + q : src, ok ? 4 : 0);
      }
    }
  }
}

// acc[j] += a * b[j] for the four lanes of b
__device__ __forceinline__ void fma4(float* acc, float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// row[col + j] = v[j] for col + j < width; one 16-byte store where `vec`
// (row 16-byte aligned, width a multiple of 4)
__device__ __forceinline__ void store4(float* row, int col, int width,
                                       const float* v, bool vec) {
  if (vec) {
    if (col < width)
      *reinterpret_cast<float4*>(row + col) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < width) row[col + j] = v[j];
  }
}

// cum[t] = sum_{t' <= t} dt[t'] a for t < Q, as a block-wide scan: each
// thread sums a run of ceil(Q / NT) steps, then the runs are scanned across
// the warps.  `warp_sums` holds 8 floats.
__device__ void block_cumsum(float* cum, const float* dt, float a, int Q,
                             float* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (Q + NT - 1) / NT, lo = min(Q, tid * per),
            hi = min(Q, lo + per);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    run += dt[t] * a;
    cum[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float v = lane < NT / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < NT / 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    if (lane < NT / 32) warp_sums[lane] = v;
  }
  __syncthreads();
  float before = __shfl_up_sync(0xffffffffu, incl, 1);   // the runs before
  if (lane == 0) before = 0.f;
  if (warp > 0) before += warp_sums[warp - 1];
  for (int t = lo; t < hi; ++t) cum[t] += before;
  __syncthreads();
}

// ---- 1. C.B^T -------------------------------------------------------------
// Block (pair, chunk, b * G + g); pair enumerates the tiles (st, tt) with
// tt <= st.  Thread (ty, tx) owns rows s = 4 ty + i and columns t = tx + 16 j.
__global__ void __launch_bounds__(NT)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cb, Dims d) {
  const int S = d.S, N = d.N, G = d.G, Q = d.Q;
  const int ldn = n4(N) + 4;
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);   // (TS, ldn)
  float* sB = sC + TS * ldn;                     // (TS, ldn)

  int st = 0, tt = blockIdx.x;
  while (tt > st) tt -= ++st;
  const int ci = blockIdx.y, c0 = ci * Q;
  const int b = blockIdx.z / G, g = blockIdx.z % G;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long brow = (long long)G * N;
  const long long base = ((long long)b * S + c0) * brow + (long long)g * N;
  const int s0 = st * TS, t0 = tt * TS;
  load_tile(sC, ldn, TS, n4(N) / 4, cm + base + s0 * brow, brow,
            min(Q - s0, S - c0 - s0), N, d.vec_bc);
  load_tile(sB, ldn, TS, n4(N) / 4, bm + base + t0 * brow, brow,
            min(Q - t0, S - c0 - t0), N, d.vec_bc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float sc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
  for (int n = 0; n < n4(N); n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cv[i] = *reinterpret_cast<const float4*>(&sC[(ty * 4 + i) * ldn + n]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&sB[(tx + 16 * j) * ldn + n]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = sc[i][j];
        s = fmaf(cv[i].x, bv[j].x, s);
        s = fmaf(cv[i].y, bv[j].y, s);
        s = fmaf(cv[i].z, bv[j].z, s);
        s = fmaf(cv[i].w, bv[j].w, s);
        sc[i][j] = s;
      }
  }
  float* out = cb + (((long long)b * G + g) * d.nc + ci) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx + 16 * j;
      if (t < Q) out[(long long)s * Q + t] = sc[i][j];
    }
  }
}

// ---- 2. chunk cumsum and chunk state --------------------------------------
// Block (chunk, h * ptiles + pt, b).  The state tile is (n, p): thread
// (ty, tx) owns n = NI ty + i and p = p0 + 4 tx + j; columns of b past N load
// as zeros.
__global__ void __launch_bounds__(NT)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a_log,
                       const float* __restrict__ bm, float* __restrict__ cum,
                       float* __restrict__ states, Dims d) {
  constexpr int LDB = 16 * NI;
  const int S = d.S, H = d.H, P = d.P, N = d.N, G = d.G, Q = d.Q;
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);   // 2 x (TK, TS)
  float* sB = sX + 2 * TK * TS;                  // 2 x (TK, LDB)
  float* sDt = sB + 2 * TK * LDB;                // (Q,)
  float* sCum = sDt + Q;                         // (Q,)
  float* sW = sCum + Q;                          // (Q,)
  float* sWarp = sW + Q;                         // (8,)

  const int ci = blockIdx.x, c0 = ci * Q, b = blockIdx.z;
  const int np = ptiles(P), h = blockIdx.y / np, pt = blockIdx.y % np;
  const int p0 = pt * TS, pw = min(TS, P - p0);
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long xrow = (long long)H * P, brow = (long long)G * N;
  const float* xb = x + ((long long)b * S + c0) * xrow + (long long)h * P + p0;
  const float* bb = bm + ((long long)b * S + c0) * brow + (long long)g * N;
  const int ntk = (Q + TK - 1) / TK;

  const auto issue = [&](int k) {
    const int t0 = k * TK, valid = min(Q - t0, S - c0 - t0);
    load_tile(sX + (k & 1) * TK * TS, TS, TK, TS / 4, xb + t0 * xrow, xrow,
              valid, pw, d.vec_x);
    load_tile(sB + (k & 1) * TK * LDB, LDB, TK, LDB / 4, bb + t0 * brow, brow,
              valid, N, d.vec_bc);
    cp_async_commit();
  };
  issue(0);                  // in flight during the scan

  const float a = -expf(a_log[h]);
  for (int t = tid; t < Q; t += NT)
    sDt[t] = c0 + t < S ? dt[((long long)b * S + c0 + t) * H + h] : 0.f;
  __syncthreads();
  block_cumsum(sCum, sDt, a, Q, sWarp);
  const float cum_last = sCum[Q - 1];
  float* cumc = cum + ((long long)b * d.nc + ci) * Q * H + h;
  for (int t = tid; t < Q; t += NT) {
    if (pt == 0) cumc[(long long)t * H] = sCum[t];
    sW[t] = sDt[t] * expf(cum_last - sCum[t]);
  }

  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < ntk; ++k) {
    if (k + 1 < ntk) issue(k + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* cx = sX + (k & 1) * TK * TS;
    const float* cbt = sB + (k & 1) * TK * LDB;
    const float* w = sW + k * TK;
    const int rows = min(TK, Q - k * TK);
    for (int t = 0; t < rows; ++t) {
      const float wt = w[t];
      const float4 xr = *reinterpret_cast<const float4*>(&cx[t * TS + 4 * tx]);
      const float xv[4] = {xr.x * wt, xr.y * wt, xr.z * wt, xr.w * wt};
      float bv[NI];
#pragma unroll
      for (int i = 0; i < NI; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&cbt[t * LDB + ty * NI + i]);
        bv[i] = v.x;
        bv[i + 1] = v.y;
        bv[i + 2] = v.z;
        bv[i + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
    }
    __syncthreads();          // before the copy after next overwrites
  }

  float* out = states + (((long long)b * d.nc + ci) * H + h) * N * P + p0;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int n = ty * NI + i;
    if (n < N) store4(out + (long long)n * P, 4 * tx, pw, acc[i], d.vec_x);
  }
}

// ---- 3. state passing -----------------------------------------------------
// Thread e = (n, p) of head (blockIdx.y, blockIdx.z).
__global__ void __launch_bounds__(NT)
ssd_state_passing_kernel(const float* __restrict__ src,
                         float* __restrict__ h_in,
                         const float* __restrict__ cum,
                         float* __restrict__ state, Dims d) {
  const int H = d.H, P = d.P, N = d.N, Q = d.Q, nc = d.nc;
  const int e = blockIdx.x * NT + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (e >= N * P) return;
  const long long step = (long long)H * N * P;   // one chunk further
  const long long off = ((long long)b * nc * H + h) * N * P + e;
  const float* last = cum + (long long)b * nc * Q * H + (long long)(Q - 1) * H + h;
  float carry = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float s[8], dec[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k;
      s[k] = c < nc ? src[off + c * step] : 0.f;
      dec[k] = c < nc ? expf(last[(long long)c * Q * H]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k >= nc) break;
      h_in[off + (c0 + k) * step] = carry;
      carry = __fadd_rn(__fmul_rn(carry, dec[k]), s[k]);
    }
  }
  const int n = e / P, p = e - n * P;
  state[(((long long)b * H + h) * P + p) * N + n] = carry;
}

// ---- 4. chunk scan --------------------------------------------------------
// Block (rev(st) * ptiles + pt, chunk, b * H + h).  Thread (ty, tx) owns rows
// s = s0 + 4 ty + i and columns p = p0 + 4 tx + j.
__global__ void __launch_bounds__(NT)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ cm,
                      const float* __restrict__ cb,
                      const float* __restrict__ cum,
                      const float* __restrict__ h_in, float* __restrict__ y,
                      Dims d) {
  const int S = d.S, H = d.H, P = d.P, N = d.N, G = d.G, Q = d.Q;
  const int ldn = n4(N) + 4;
  extern __shared__ float4 smem4[];
  float* sU = reinterpret_cast<float*>(smem4);   // union of the two phases:
  float* sC = sU;                                //   (TS, ldn) C rows
  float* sH = sC + TS * ldn;                     //   (n4(N), TS) h_in^T
  float* sX = sU;                                //   2 x (TS, TS) x rows
  float* sW = sX + 2 * TS * TS;                  //   (TS, LDW) scores
  const int u_len = max(TS * ldn + n4(N) * TS, 2 * TS * TS + TS * LDW);
  float* sDt = sU + u_len;                       // (Q,)
  float* sCum = sDt + Q;                         // (Q,)

  const int np = ptiles(P), nq = qtiles(Q);
  const int st = nq - 1 - blockIdx.x / np, pt = blockIdx.x % np;
  const int ci = blockIdx.y, c0 = ci * Q;
  const int b = blockIdx.z / H, h = blockIdx.z % H, g = h / (H / G);
  const int s0 = st * TS, p0 = pt * TS, pw = min(TS, P - p0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long xrow = (long long)H * P, brow = (long long)G * N;
  const float* xb = x + ((long long)b * S + c0) * xrow + (long long)h * P + p0;

  load_tile(sC, ldn, TS, n4(N) / 4,
            cm + ((long long)b * S + c0 + s0) * brow + (long long)g * N, brow,
            min(Q - s0, S - c0 - s0), N, d.vec_bc);
  load_tile(sH, TS, n4(N), TS / 4,
            h_in + (((long long)b * d.nc + ci) * H + h) * N * P + p0, P, N,
            pw, d.vec_x);
  cp_async_commit();
  const float* cumc = cum + ((long long)b * d.nc + ci) * Q * H + h;
  for (int t = tid; t < Q; t += NT) {
    sDt[t] = c0 + t < S ? dt[((long long)b * S + c0 + t) * H + h] : 0.f;
    sCum[t] = cumc[(long long)t * H];
  }
  cp_async_wait<0>();
  __syncthreads();

  // inter-chunk: exp(cum_s) C_s . h_in
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n = 0; n < n4(N); n += 4) {
    float4 cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cv[i] = *reinterpret_cast<const float4*>(&sC[(ty * 4 + i) * ldn + n]);
    float4 hv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hv[k] = *reinterpret_cast<const float4*>(&sH[(n + k) * TS + 4 * tx]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cvi[4] = {cv[i].x, cv[i].y, cv[i].z, cv[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) fma4(acc[i], cvi[k], hv[k]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    const float f = s < Q ? expf(sCum[s]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= f;
  }
  __syncthreads();            // sC and sH are done: the union turns over

  // intra-chunk: (C.B^T * exp(cum_s - cum_t) dt_t [t <= s]) . x_t
  const float* cbc = cb + ((((long long)b * G + g) * d.nc + ci) * Q) * Q;
  const auto issue = [&](int tt) {
    const int t0 = tt * TS;
    load_tile(sX + (tt & 1) * TS * TS, TS, TS, TS / 4, xb + t0 * xrow, xrow,
              min(Q - t0, S - c0 - t0), pw, d.vec_x);
    cp_async_commit();
  };
  issue(0);
  for (int tt = 0; tt <= st; ++tt) {
    const int t0 = tt * TS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        sW[(ty * 4 + i) * LDW + tx + 16 * j] =
            (t <= s && s < Q)
                ? cbc[(long long)s * Q + t] * expf(sCum[s] - sCum[t]) * sDt[t]
                : 0.f;
      }
    }
    if (tt < st) issue(tt + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* cx = sX + (tt & 1) * TS * TS;
#pragma unroll 4
    for (int t = 0; t < TS; t += 4) {
      float4 w4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w4[i] = *reinterpret_cast<const float4*>(&sW[(ty * 4 + i) * LDW + t]);
      float4 xv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        xv[k] = *reinterpret_cast<const float4*>(&cx[(t + k) * TS + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wi[4] = {w4[i].x, w4[i].y, w4[i].z, w4[i].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) fma4(acc[i], wi[k], xv[k]);
      }
    }
    __syncthreads();          // before sW and the next x buffer are rewritten
  }

  float* yb = y + ((long long)b * S + c0) * xrow + (long long)h * P + p0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s < Q && c0 + s < S)
      store4(yb + (long long)s * xrow, 4 * tx, pw, acc[i], d.vec_x);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(floats * sizeof(float)));
}

bool aligned(const float* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// Shared memory of the largest of the kernels, for the wrapper's check.
extern "C" size_t ssd_scan_smem_bytes(int N, int Q) {
  size_t m = cb_smem(N);
  if (state_smem(Q) > m) m = state_smem(Q);
  if (scan_smem(N, Q) > m) m = scan_smem(N, Q);
  return m * sizeof(float);
}

// Q is the chunk length, min(chunk, S), as the TPU kernel's wrapper takes
// it.  Scratch: cb (B, G, nc, Q, Q), cum (B, nc, Q, H), cstate and h_in
// (B, nc, H, N, P), nc = ceil(S / Q).  Launches the four kernels on `stream`.  Returns a
// cudaError_t code (0 = launched).
extern "C" int ssd_scan_fwd(const float* x, const float* dt,
                            const float* a_log, const float* b,
                            const float* c, float* cb, float* cum,
                            float* cstate, float* h_in, float* y,
                            float* state, int B, int S, int H, int P, int G,
                            int N, int Q, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || N <= 0 ||
      N > 128 || Q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Dims d{S, H, P, N, G, Q, (S + Q - 1) / Q,
               N % 4 == 0 && aligned(b) && aligned(c),
               P % 4 == 0 && aligned(x) && aligned(h_in) && aligned(y) &&
                   aligned(cstate)};
  const int nq = qtiles(Q), np = ptiles(P);

  cudaError_t err = set_smem(ssd_cb_kernel, cb_smem(N));
  if (err != cudaSuccess) return (int)err;
  ssd_cb_kernel<<<dim3(nq * (nq + 1) / 2, d.nc, B * G), NT,
                  cb_smem(N) * sizeof(float), stream>>>(b, c, cb, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = set_smem(ssd_chunk_state_kernel, state_smem(Q))) != cudaSuccess)
    return (int)err;
  ssd_chunk_state_kernel<<<dim3(d.nc, H * np, B), NT,
                           state_smem(Q) * sizeof(float), stream>>>(
      x, dt, a_log, b, cum, cstate, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_state_passing_kernel<<<dim3((N * P + NT - 1) / NT, H, B), NT, 0,
                             stream>>>(cstate, h_in, cum, state, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = set_smem(ssd_chunk_scan_kernel, scan_smem(N, Q))) != cudaSuccess)
    return (int)err;
  ssd_chunk_scan_kernel<<<dim3(nq * np, d.nc, B * H), NT,
                          scan_smem(N, Q) * sizeof(float), stream>>>(
      x, dt, c, cb, cum, h_in, y, d);
  return (int)cudaGetLastError();
}
