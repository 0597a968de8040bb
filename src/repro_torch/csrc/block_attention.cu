// Hyper-block self-attention: softmax(Q K^T / sqrt(d_h)) V per hyper-block.
//
// Replaces the TPU kernel `_block_attn_kernel` / `block_attention_fwd`
// (src/repro/kernels/block_attention/kernel.py:27, :47).
//
// Shapes: q, k (B, n, dk), v (B, n, dv), fp32, contiguous; n is the number of
// blocks in a hyper-block (10, 5 or 8 in the paper's configs) and d = 128.
// Head h reads columns [h*d/heads, (h+1)*d/heads), as the reshape
// (tb, n, heads, d/heads) of the TPU kernel does.
//
// Bound on the H100: bytes.  A hyper-block reads 3*n*d floats and writes
// n*d, and does about 4*n*n*d flops: at n = 10 that is 2.5 flops a byte,
// against the card's ~20 fp32 flops a byte.  So the design keeps everything
// of one hyper-block in shared memory and touches device memory once per
// input and output element: one thread block per hyper-block (the grid is
// exactly B, no padding), Q, K and V staged in shared memory with rows padded
// by one float so the score loop's strided reads hit distinct banks, the
// (heads, n, n) scores computed and soft-maxed in fp32 in shared memory, and
// the output written row by row with neighbouring threads on neighbouring
// columns.  Tensor cores would not help at n <= 16.
#include <cuda_runtime.h>
#include <math.h>

__global__ void block_attention_kernel(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       float* __restrict__ o,
                                       int n, int dk, int dv, int heads) {
  extern __shared__ float smem[];
  const int ldk = dk + 1, ldv = dv + 1;
  float* sq = smem;                    // (n, ldk)
  float* sk = sq + n * ldk;            // (n, ldk)
  float* sv = sk + n * ldk;            // (n, ldv)
  float* ss = sv + n * ldv;            // (heads, n, n) scores, then weights

  const long long b = blockIdx.x;
  const float* qb = q + b * n * dk;
  const float* kb = k + b * n * dk;
  const float* vb = v + b * n * dv;
  float* ob = o + b * n * dv;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < n * dk; e += nt) {
    int r = e / dk, c = e - r * dk;
    sq[r * ldk + c] = qb[e];
    sk[r * ldk + c] = kb[e];
  }
  for (int e = tid; e < n * dv; e += nt) {
    int r = e / dv, c = e - r * dv;
    sv[r * ldv + c] = vb[e];
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
    ob[e] = acc;
  }
}

extern "C" int block_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int batch, int n,
                                   int dk, int dv, int heads,
                                   cudaStream_t stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  size_t smem = sizeof(float) *
                ((size_t)n * (dk + 1) * 2 + (size_t)n * (dv + 1) +
                 (size_t)heads * n * n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_attention_kernel<<<batch, 128, smem, stream>>>(q, k, v, o, n, dk, dv,
                                                       heads);
  return (int)cudaGetLastError();
}
