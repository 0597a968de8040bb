// GAE projection: c = R @ U and c2 = c^2 in one pass, in IEEE fp32.
//
// Replaces the TPU kernel `_gae_project_kernel` / `gae_project_fwd`
// (src/repro/kernels/gae_project/kernel.py:25, :44).
//
// Shapes: R (N, D), U (D, Dout), fp32, row-major, contiguous.  On the main
// path D = Dout = 80 (S3D), 256 (E3SM) or 1521 (XGC), and N is the number of
// GAE blocks in a stripe (37 120 for S3D).
//
// Bound on the H100: at D = 80 the kernel moves 12 bytes of output and 4 of
// input per 160 flops of coefficient, so bytes bound it (35.7 MB against
// 0.48 GFLOP at (37 120, 80)); at D = 1521 (XGC) the fp32 flops do.  The
// reference multiplies in full fp32 (preferred_element_type=float32) and the
// GAE error accounting sums squared coefficients against tau^2, so TF32
// tensor cores are out: both paths are SIMT GEMMs with fp32 FMA, summing
// over k in order, and c2 is `__fmul_rn(c, c)` of the same registers.
//
// Two paths, chosen by shape:
//  * resident (D and Dout <= 128, multiples of 4, every pointer 16-byte
//    aligned: the S3D shape, D = Dout = 80): a block owns 40 rows and every
//    output column, so R is read once and no FMA is spent on a masked
//    column.  U (25.6 KB at D = 80) is copied into shared memory
//    once per block, and the blocks are persistent (as many as fit on the
//    SMs) and loop over the row tiles.  R tiles come through a 2-stage ring
//    filled by `cp.async`: the next tile's copy is in flight while this
//    tile's FMAs run.  A tile of R is one contiguous span of memory, and so
//    is its tile of c, because the block owns every column: the tile is
//    copied in 16-byte pieces, and c and c2 are written straight from the
//    registers as 16-byte stores that cover whole lines (no staging, one
//    barrier a tile), so they drain while the next tile's FMAs run.  Each
//    of the 8 x Dout/4 threads (160 at 80) holds 5 rows x 4 columns, read
//    from shared memory 16 bytes at a time.  On the H100 the FMA loop and
//    its shared-memory reads, more than the copies, set the pace.  Of the
//    tilings tried (8 x 8, 8 x 5, 8 x 4 and 4 x 4 register tiles, 32- to
//    128-row tiles, k-sliced rings, a lane per row), 40 rows of 5 x 4 a
//    thread was the fastest; with 64-row tiles the time also varied from
//    call to call with how the blocks' tiles fell on the SMs.
//  * tiled (everything else: E3SM and XGC, and any ragged width): 64 x 64
//    tiles of c, 256 threads of 4 x 4, 16-deep slices of R and U
//    double-buffered in shared memory (the next slice's loads are issued
//    before this slice's FMAs, one barrier per slice), edges masked in the
//    loads with zeros, c and c2 stored 16 bytes a thread where Dout allows
//    it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---- resident path --------------------------------------------------------
constexpr int RG = 8;           // row groups of a block
constexpr int RPT = 5;          // rows a thread holds
constexpr int RM = RG * RPT;    // rows of a tile
constexpr int RMAX = 128;       // largest D and Dout of the resident path

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[j] += a * b[j] for the four lanes of b
__device__ __forceinline__ void fma4(float* acc, float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// `count` (a multiple of 4) contiguous floats from `src` to `dst`, both
// 16-byte aligned, 16 bytes a copy.
__device__ __forceinline__ void copy_span(float* dst, const float* src,
                                          long long count) {
  for (long long e = threadIdx.x * 4; e < count; e += blockDim.x * 4)
    cp_async16(dst + e, src + e);
}

size_t resident_smem_bytes(int d, int dout) {
  return sizeof(float) * ((size_t)d * dout + 2 * (size_t)RM * d);
}

// RG * Dout / 4 threads (160 at Dout = 80): thread (ty, tx) owns rows
// ty + RG i (i < RPT) and columns 4 tx .. 4 tx + 3.  D and Dout are
// multiples of 4, so rows of R and U are read as float4 and c, c2 written so.
__global__ void __launch_bounds__(512)
gae_project_resident(const float* __restrict__ r, const float* __restrict__ u,
                     float* __restrict__ c, float* __restrict__ c2, int n,
                     int d, int dout) {
  extern __shared__ float4 smem4[];
  float* sU = reinterpret_cast<float*>(smem4);   // (d, dout)
  float* sR = sU + d * dout;                     // 2 stages of RM rows
  const int stage = RM * d;

  const int tid = threadIdx.x, gt = dout / 4;
  const int tx = tid % gt, ty = tid / gt;
  const int ntiles = (n + RM - 1) / RM;

  int tile = blockIdx.x;
  if (tile >= ntiles) return;
  copy_span(sU, u, (long long)d * dout);
  copy_span(sR, r + (long long)tile * RM * d,
            (long long)min(RM, n - tile * RM) * d);
  cp_async_commit();

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    cp_async_wait<0>();       // this tile (and U) has landed
    __syncthreads();          // ... for every thread, and the other buffer's
                              // last reader is done
    const int next = tile + gridDim.x;
    if (next < ntiles) {      // in flight while this tile's FMAs run
      copy_span(sR + ((it + 1) & 1) * stage, r + (long long)next * RM * d,
                (long long)min(RM, n - next * RM) * d);
      cp_async_commit();
    }
    const float* cur = sR + (it & 1) * stage;
    const float* ucol = sU + 4 * tx;

    float acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int k = 0; k < d; k += 4) {
      float4 a[RPT], b[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a[i] = *reinterpret_cast<const float4*>(&cur[(ty + RG * i) * d + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        b[kk] = *reinterpret_cast<const float4*>(&ucol[(k + kk) * dout]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fma4(acc[i], av[kk], b[kk]);
      }
    }

    // c and c2 straight from the registers: the tile's rows are adjacent in
    // memory, so a warp's 16-byte stores cover whole contiguous lines
    const int col = 4 * tx;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long long row = (long long)tile * RM + ty + RG * i;
      if (row >= n) break;
      const float* v = acc[i];
      *reinterpret_cast<float4*>(c + row * dout + col) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(c2 + row * dout + col) =
          make_float4(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1]),
                      __fmul_rn(v[2], v[2]), __fmul_rn(v[3], v[3]));
    }
  }
}

int launch_resident(const float* r, const float* u, float* c, float* c2,
                    int n, int d, int dout, cudaStream_t stream) {
  const size_t smem = resident_smem_bytes(d, dout);
  const int threads = RG * dout / 4;
  cudaError_t err = cudaFuncSetAttribute(
      gae_project_resident, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gae_project_resident, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (n + RM - 1) / RM;
  const int grid = min(ntiles, max(1, per_sm) * sms);
  gae_project_resident<<<grid, threads, smem, stream>>>(r, u, c, c2, n, d,
                                                        dout);
  return (int)cudaGetLastError();
}

// ---- tiled path -----------------------------------------------------------
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TT = 256;

__global__ void __launch_bounds__(TT)
gae_project_tiled(const float* __restrict__ r, const float* __restrict__ u,
                  float* __restrict__ c, float* __restrict__ c2, int n, int d,
                  int dout, bool vec_c) {
  __shared__ __align__(16) float as[2][BK][BM + 4];   // R slice: as[kk][row]
  __shared__ __align__(16) float bs[2][BK][BN + 4];   // U slice: bs[kk][col]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4), ty = tid / (BN / 4);
  const long long row0 = (long long)blockIdx.x * BM;   // rows on x: no 65535 cap
  const int col0 = blockIdx.y * BN;

  // this thread's four elements of each slice: R (m, kk), U (kk, nn)
  float ra[4], ub[4];
  const auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * TT;
      const int m = e / BK, kk = e % BK;
      const long long gr = row0 + m;
      const int gk = k0 + kk;
      ra[q] = (gr < n && gk < d) ? r[gr * d + gk] : 0.f;
      const int kb = e / BN, nn = e % BN;
      const int gkb = k0 + kb, gc = col0 + nn;
      ub[q] = (gkb < d && gc < dout) ? u[(long long)gkb * dout + gc] : 0.f;
    }
  };
  const auto stash = [&](int s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * TT;
      as[s][e % BK][e / BK] = ra[q];
      bs[s][e / BN][e % BN] = ub[q];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < d; k0 += BK, s ^= 1) {
    const bool more = k0 + BK < d;
    if (more) fetch(k0 + BK);           // in flight while the FMAs run
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[s][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[s][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) stash(s ^ 1);   // that buffer was last read before the barrier
    __syncthreads();
  }

  const int gc = col0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gr = row0 + ty * 4 + i;
    if (gr >= n) continue;
    float* cr = c + gr * dout;
    float* c2r = c2 + gr * dout;
    if (vec_c && gc + 3 < dout) {
      *reinterpret_cast<float4*>(&cr[gc]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(&c2r[gc]) = make_float4(
          __fmul_rn(acc[i][0], acc[i][0]), __fmul_rn(acc[i][1], acc[i][1]),
          __fmul_rn(acc[i][2], acc[i][2]), __fmul_rn(acc[i][3], acc[i][3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gc + j < dout) {
          cr[gc + j] = acc[i][j];
          c2r[gc + j] = __fmul_rn(acc[i][j], acc[i][j]);
        }
    }
  }
}

}  // namespace

extern "C" int gae_project_f32(const float* r, const float* u, float* c,
                               float* c2, int n, int d, int dout,
                               cudaStream_t stream) {
  if (n <= 0 || dout <= 0) return (int)cudaGetLastError();
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const bool vec_c = aligned16(c) && aligned16(c2);
  if (d <= RMAX && dout <= RMAX && d % 4 == 0 && dout % 4 == 0 && vec_c &&
      aligned16(r) && aligned16(u))
    return launch_resident(r, u, c, c2, n, d, dout, stream);
  dim3 grid((n + BM - 1) / BM, (dout + BN - 1) / BN);
  gae_project_tiled<<<grid, TT, 0, stream>>>(r, u, c, c2, n, d, dout,
                                             vec_c && dout % 4 == 0);
  return (int)cudaGetLastError();
}
