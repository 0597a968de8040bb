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
// The TPU kernel runs one program per (b, h), walking the chunks in order
// with the state in VMEM.  On Hopper that is B * H = 32 blocks for 132 SMs,
// each recomputing C.B^T, which is the largest product and the same for
// every head of a group.  So the work is split in two kernels:
//   1. `ssd_cb_kernel`, one block per (b, group, chunk): the chunk's
//      C.B^T on and below the diagonal, in 64 x 64 tiles from shared
//      memory, written to a (B, G, nc, Q, Q) fp32 scratch (4 MB for
//      mamba2-370m at S = 4096, read back from L2);
//   2. `ssd_scan_kernel`, one block per (b, h, 16 columns of P): 128 blocks
//      for mamba2-370m.  It walks the chunks in order with its (16, N) slice
//      of the state in shared memory (the state's rows are independent in
//      p), and per chunk: cum = cumsum(dt * a) once in fp32 (one warp, a
//      segmented scan), the inter-chunk term exp(cum_s) C_s . h_in, the
//      intra-chunk term (C.B^T * exp(cum_s - cum_t) [t <= s]) . (x dt) over
//      64-row tiles, and the state update exp(cum_last) h +
//      sum_t exp(cum_last - cum_t) (x dt)_t b_t^T.  The state reaches device
//      memory once, at the end.
// Operands are read as float4 from rows padded by four floats, so that the
// reads hit distinct banks.  A ragged S is handled in the loads: positions
// at or beyond S read as dt = 0, x = b = c = 0, which is exactly the padded
// call's input, so the final state is bit-identical to that of a call padded
// with dt = 0, and y rows beyond S are not written.
// Built with -O3 and no --use_fast_math: `expf` is the accurate one.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TS = 64;          // rows of a query or key tile within a chunk
constexpr int PL = 16;          // columns of P per scan block
constexpr int NT = 256;         // threads per block, 16 x 16
constexpr int LDS = TS + 4;     // row stride of the scores tile

struct Dims {
  int S, H, P, N, G, Q, nc;
  bool vec_bc, vec_x;   // b, c (x) rows are 16-byte aligned float4 groups
};

__host__ __device__ inline int n4(int N) { return (N + 3) / 4 * 4; }

size_t cb_smem_bytes(int N) {
  return sizeof(float) * 2 * TS * (size_t)(n4(N) + 4);
}

// floats of shared memory of the scan: state slice, one C or B tile, x*dt
// tile, scores tile, dt and cum of one chunk
size_t scan_smem_bytes(int N, int Q) {
  const size_t ldn = n4(N) + 4;
  return sizeof(float) * (PL * ldn + TS * ldn + TS * PL + TS * LDS + 2 * (size_t)Q);
}

// Rows [t0, t0 + TS) of the chunk at c0 of a (S, row_stride) operand into a
// shared tile of row stride ldn; zero beyond the chunk's Q rows, beyond S and
// beyond N.  Each thread first issues all its loads (at most 8 groups of
// four floats: TS * 128 / 4 / NT), then stores them, so that their latencies
// overlap; `vec` (N % 4 == 0, rows 16-byte aligned) loads each group as one
// float4.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row_stride, int c0,
                                          int t0, int Q, int S, int N,
                                          int ldn, bool vec) {
  const int w4 = n4(N) / 4;
  float4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = threadIdx.x + k * NT;
    const int r = e / w4, n = (e - r * w4) * 4, t = t0 + r, pos = c0 + t;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < TS * w4 && t < Q && pos < S) {
      const float* row = src + pos * row_stride + n;
      if (vec) {
        v[k] = *reinterpret_cast<const float4*>(row);
      } else {
        v[k].x = row[0];
        if (n + 1 < N) v[k].y = row[1];
        if (n + 2 < N) v[k].z = row[2];
        if (n + 3 < N) v[k].w = row[3];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = threadIdx.x + k * NT;
    const int r = e / w4, n = (e - r * w4) * 4;
    if (e < TS * w4) *reinterpret_cast<float4*>(&dst[r * ldn + n]) = v[k];
  }
}

// Rows [t0, t0 + TS) of this block's PL columns of x, times dt (and, for the
// state update, times exp(cum_last - cum_t)), into the (TS, PL) tile: one
// group of four columns per thread, loaded before it is stored.
__device__ __forceinline__ void load_xdt(float* dst, const float* xb,
                                         long long xrow, const float* sDt,
                                         const float* sCum, float cum_last,
                                         bool edge, int c0, int t0, int Q,
                                         int S, int pw, bool vec) {
  const int r = threadIdx.x / (PL / 4), p = (threadIdx.x % (PL / 4)) * 4;
  const int t = t0 + r, pos = c0 + t;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t < Q && pos < S && p < pw) {
    const float* row = xb + pos * xrow + p;
    if (vec) {
      v = *reinterpret_cast<const float4*>(row);
    } else {
      v.x = row[0];
      if (p + 1 < pw) v.y = row[1];
      if (p + 2 < pw) v.z = row[2];
      if (p + 3 < pw) v.w = row[3];
    }
    const float f = edge ? sDt[t] * expf(cum_last - sCum[t]) : sDt[t];
    v.x *= f;
    v.y *= f;
    v.z *= f;
    v.w *= f;
  }
  *reinterpret_cast<float4*>(&dst[r * PL + p]) = v;
}

// C.B^T of one chunk of one (b, group), tiles on and below the diagonal.
__global__ void __launch_bounds__(NT)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cb, Dims d) {
  const int S = d.S, N = d.N, G = d.G, Q = d.Q;
  const int ldn = n4(N) + 4;
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);   // (TS, ldn)
  float* sB = sC + TS * ldn;                     // (TS, ldn)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ci = blockIdx.x, g = blockIdx.y, b = blockIdx.z, c0 = ci * Q;
  const long long brow = (long long)G * N;
  const float* bb = bm + (long long)b * S * brow + (long long)g * N;
  const float* cc = cm + (long long)b * S * brow + (long long)g * N;
  float* out = cb + (((long long)b * G + g) * d.nc + ci) * Q * Q;

  const int ntiles = (Q + TS - 1) / TS;
  for (int st = 0; st < ntiles; ++st) {
    __syncthreads();
    load_rows(sC, cc, brow, c0, st * TS, Q, S, N, ldn, d.vec_bc);
    for (int tt = 0; tt <= st; ++tt) {
      if (tt) __syncthreads();
      load_rows(sB, bb, brow, c0, tt * TS, Q, S, N, ldn, d.vec_bc);
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = st * TS + ty * 4 + i;
        if (s >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tt * TS + tx + 16 * j;
          if (t < Q) out[(long long)s * Q + t] = sc[i][j];
        }
      }
    }
  }
}

template <int NTT>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ cb,
                float* __restrict__ y, float* __restrict__ state, Dims d) {
  const int S = d.S, H = d.H, P = d.P, N = d.N, G = d.G, Q = d.Q;
  const int ldn = n4(N) + 4;
  extern __shared__ float4 smem4[];
  float* sH = reinterpret_cast<float*>(smem4);   // (PL, ldn) state slice
  float* sT = sH + PL * ldn;                     // (TS, ldn) C or B tile
  float* sX = sT + TS * ldn;                     // (TS, PL) x*dt tile
  float* sS = sX + TS * PL;                      // (TS, LDS) scores tile
  float* sDt = sS + TS * LDS;                    // (Q,)
  float* sCum = sDt + Q;                         // (Q,)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * PL;
  const int g = h / (H / G);
  const float a = -expf(a_log[h]);
  const long long xrow = (long long)H * P, brow = (long long)G * N;
  const float* xb = x + (long long)b * S * xrow + (long long)h * P + p0;
  const float* dtb = dt + (long long)b * S * H + h;
  const float* bb = bm + (long long)b * S * brow + (long long)g * N;
  const float* cc = cm + (long long)b * S * brow + (long long)g * N;
  const float* cbb = cb + ((long long)b * G + g) * d.nc * Q * Q;
  float* yb = y + (long long)b * S * xrow + (long long)h * P + p0;
  const int pw = min(PL, P - p0);               // this block's columns of P

  for (int e = tid; e < PL * ldn; e += NT) sH[e] = 0.f;

  const int ntiles = (Q + TS - 1) / TS;
  for (int ci = 0; ci < d.nc; ++ci) {
    const int c0 = ci * Q;
    const float* cbc = cbb + (long long)ci * Q * Q;
    __syncthreads();          // the previous chunk is done with every tile
    for (int t = tid; t < Q; t += NT)
      sDt[t] = c0 + t < S ? dtb[(long long)(c0 + t) * H] : 0.f;
    __syncthreads();
    if (tid < 32) {           // cum = inclusive cumsum of dt * a, one warp
      const int per = (Q + 31) / 32, lo = tid * per, hi = min(Q, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += sDt[t] * a;
        sCum[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      const float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid > 0)
        for (int t = lo; t < hi; ++t) sCum[t] += before;
    }
    __syncthreads();
    const float cum_last = sCum[Q - 1];

    for (int st = 0; st < ntiles; ++st) {
      const int s0 = st * TS;
      load_rows(sT, cc, brow, c0, s0, Q, S, N, ldn, d.vec_bc);
      __syncthreads();

      // inter-chunk: acc = exp(cum_s) * C_s . h_in; rows 4*ty + i, column tx
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n = 0; n < n4(N); n += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(&sH[tx * ldn + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&sT[(ty * 4 + i) * ldn + n]);
          float s = acc[i];
          s = fmaf(cv.x, hv.x, s);
          s = fmaf(cv.y, hv.y, s);
          s = fmaf(cv.z, hv.z, s);
          s = fmaf(cv.w, hv.w, s);
          acc[i] = s;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + ty * 4 + i;
        acc[i] *= s < Q ? expf(sCum[s]) : 0.f;
      }

      // intra-chunk: acc += (C.B^T * exp(cum_s - cum_t) [t <= s]) . xdt_t
      for (int tt = 0; tt <= st; ++tt) {
        const int t0 = tt * TS;
        load_xdt(sX, xb, xrow, sDt, sCum, cum_last, false, c0, t0, Q, S, pw,
                 d.vec_x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + tx + 16 * j;
            sS[(ty * 4 + i) * LDS + tx + 16 * j] =
                (t <= s && s < Q)
                    ? cbc[(long long)s * Q + t] * expf(sCum[s] - sCum[t])
                    : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int t = 0; t < TS; t += 4) {
          float4 w4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w4[i] = *reinterpret_cast<const float4*>(&sS[(ty * 4 + i) * LDS + t]);
          const float x0 = sX[(t + 0) * PL + tx], x1 = sX[(t + 1) * PL + tx];
          const float x2 = sX[(t + 2) * PL + tx], x3 = sX[(t + 3) * PL + tx];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float s = acc[i];
            s = fmaf(w4[i].x, x0, s);
            s = fmaf(w4[i].y, x1, s);
            s = fmaf(w4[i].z, x2, s);
            s = fmaf(w4[i].w, x3, s);
            acc[i] = s;
          }
        }
        __syncthreads();      // before the next tile overwrites sX, sS
      }

      if (tx < pw) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s0 + ty * 4 + i, pos = c0 + s;
          if (s < Q && pos < S) yb[pos * xrow + tx] = acc[i];
        }
      }
    }

    // state: h = exp(cum_last) h_in + sum_t exp(cum_last - cum_t) xdt_t b_t^T;
    // this thread owns row p = ty, columns n = tx + 16 j
    float hacc[NTT];
#pragma unroll
    for (int j = 0; j < NTT; ++j) hacc[j] = 0.f;
    for (int tt = 0; tt < ntiles; ++tt) {
      const int t0 = tt * TS;
      load_rows(sT, bb, brow, c0, t0, Q, S, N, ldn, d.vec_bc);
      load_xdt(sX, xb, xrow, sDt, sCum, cum_last, true, c0, t0, Q, S, pw,
               d.vec_x);
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < TS; ++t) {
        const float xv = sX[t * PL + ty];
#pragma unroll
        for (int j = 0; j < NTT; ++j)
          hacc[j] = fmaf(xv, sT[t * ldn + tx + 16 * j], hacc[j]);
      }
      __syncthreads();
    }
    const float chunk_decay = expf(cum_last);
    if (ty < pw) {
#pragma unroll
      for (int j = 0; j < NTT; ++j) {
        const int n = tx + 16 * j;
        if (n < N) sH[ty * ldn + n] = chunk_decay * sH[ty * ldn + n] + hacc[j];
      }
    }
  }

  __syncthreads();
  float* stb = state + (((long long)b * H + h) * P + p0) * N;
  for (int e = tid; e < pw * N; e += NT) {
    const int p = e / N, n = e - p * N;
    stb[e] = sH[p * ldn + n];
  }
}

template <int NTT>
int launch_scan(const float* x, const float* dt, const float* a_log,
                const float* b, const float* c, const float* cb, float* y,
                float* state, int B, const Dims& d, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(d.N, d.Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<NTT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d.H, B, (d.P + PL - 1) / PL);
  ssd_scan_kernel<NTT><<<grid, NT, smem, stream>>>(x, dt, a_log, b, c, cb, y,
                                                   state, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of the larger of the two kernels, for the wrapper's check.
extern "C" size_t ssd_scan_smem_bytes(int N, int Q) {
  const size_t a = cb_smem_bytes(N), b = scan_smem_bytes(N, Q);
  return a > b ? a : b;
}

// Q is the chunk length, min(chunk, S), as the TPU kernel's wrapper takes
// it; cb is a (B, G, ceil(S/Q), Q, Q) fp32 scratch.  Launches the C.B^T
// kernel, then the scan, on `stream`.  Returns a cudaError_t code (0 =
// launched).
extern "C" int ssd_scan_fwd(const float* x, const float* dt,
                            const float* a_log, const float* b,
                            const float* c, float* cb, float* y, float* state,
                            int B, int S, int H, int P, int G, int N, int Q,
                            cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || N <= 0 ||
      N > 128 || Q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto aligned = [](const float* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const Dims d{S, H, P, N, G, Q, (S + Q - 1) / Q,
               N % 4 == 0 && aligned(b) && aligned(c),
               P % 4 == 0 && aligned(x)};
  const size_t cb_smem = cb_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cb_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_cb_kernel<<<dim3(d.nc, G, B), NT, cb_smem, stream>>>(b, c, cb, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ntt = (N + 15) / 16;
  if (ntt <= 1) return launch_scan<1>(x, dt, a_log, b, c, cb, y, state, B, d, stream);
  if (ntt <= 2) return launch_scan<2>(x, dt, a_log, b, c, cb, y, state, B, d, stream);
  if (ntt <= 4) return launch_scan<4>(x, dt, a_log, b, c, cb, y, state, B, d, stream);
  return launch_scan<8>(x, dt, a_log, b, c, cb, y, state, B, d, stream);
}
