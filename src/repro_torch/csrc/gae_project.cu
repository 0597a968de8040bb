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
// input per 160 flops of coefficient, about 10 flops a byte, so bytes bound
// it; at D = 1521 (XGC) the fp32 flops do.  The reference multiplies in
// full fp32 (preferred_element_type=float32) and the GAE error accounting
// sums squared coefficients against tau^2, so TF32 tensor cores are out:
// this is a SIMT GEMM with fp32 FMA.  Each 256-thread block computes a 64 x 64
// tile of C, each thread a 4 x 4 register tile, over 16-deep slices of R and U
// staged in shared memory.  Loads mask the ragged edges (80 and 1521 are not
// tile multiples) with zeros, which add nothing to the sums, so the inputs
// are never padded in device memory.  The epilogue writes c and c*c from the
// same registers.
#include <cuda_runtime.h>

#define BM 64
#define BN 64
#define BK 16
#define TM 4
#define TN 4

__global__ void __launch_bounds__(256)
gae_project_kernel(const float* __restrict__ r, const float* __restrict__ u,
                   float* __restrict__ c, float* __restrict__ c2, int n,
                   int d, int dout) {
  __shared__ float as[BK][BM + 4];   // R tile, transposed: as[kk][row]
  __shared__ float bs[BK][BN + 4];   // U tile: bs[kk][col]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const long long row0 = (long long)blockIdx.x * BM;   // rows on x: no 65535 cap
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < BM * BK; e += 256) {
      int m = e / BK, kk = e % BK;
      long long gr = row0 + m;
      int gk = k0 + kk;
      as[kk][m] = (gr < n && gk < d) ? r[gr * d + gk] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += 256) {
      int kk = e / BN, nn = e % BN;
      int gk = k0 + kk, gc = col0 + nn;
      bs[kk][nn] = (gk < d && gc < dout) ? u[(long long)gk * dout + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    long long gr = row0 + ty * TM + i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int gc = col0 + tx * TN + j;
      if (gc < dout) {
        c[gr * dout + gc] = acc[i][j];
        c2[gr * dout + gc] = __fmul_rn(acc[i][j], acc[i][j]);
      }
    }
  }
}

extern "C" int gae_project_f32(const float* r, const float* u, float* c,
                               float* c2, int n, int d, int dout,
                               cudaStream_t stream) {
  if (n <= 0 || dout <= 0) return (int)cudaGetLastError();
  dim3 grid((n + BM - 1) / BM, (dout + BN - 1) / BN);
  gae_project_kernel<<<grid, 256, 0, stream>>>(r, u, c, c2, n, d, dout);
  return (int)cudaGetLastError();
}
