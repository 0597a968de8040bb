// Fused uniform quantization: one read of x, three writes.
//
// Replaces the TPU kernel `_quantize_kernel` / `quantize_fused_fwd`
// (src/repro/kernels/quantize/kernel.py:25, :34).  For every element:
//   q    = round_half_even(x / bin)      int32
//   deq  = (float)q * bin                float32
//   err2 = (x - deq)^2                   float32
//
// Bound on the H100: bytes.  Each element moves 16 bytes (4 read, 12
// written) for a handful of flops, far below the card's ratio of flops to
// bytes, so the kernel is a grid-stride loop over a flat view that keeps
// neighbouring threads on neighbouring addresses and does nothing else.
//
// Numerics match the reference bit for bit: true IEEE division
// (__fdiv_rn, never a multiply by 1/bin, which moves half-way points into
// the other bin), rintf (round half to even, as jnp.round and torch.round),
// and explicit _rn intrinsics so the compiler cannot contract
// x - q*bin into one FMA, which would skip the rounding of deq.
#include <cuda_runtime.h>

__global__ void quantize_kernel(const float* __restrict__ x,
                                int* __restrict__ q,
                                float* __restrict__ deq,
                                float* __restrict__ err2,
                                long long n, float bin) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float xi = x[i];
    float qf = rintf(__fdiv_rn(xi, bin));
    float d = __fmul_rn(qf, bin);
    float e = __fsub_rn(xi, d);
    q[i] = (int)qf;
    deq[i] = d;
    err2[i] = __fmul_rn(e, e);
  }
}

extern "C" int quantize_f32(const float* x, int* q, float* deq, float* err2,
                            long long n, float bin, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride past 16 blocks/SM
  quantize_kernel<<<(unsigned)blocks, threads, 0, stream>>>(x, q, deq, err2,
                                                            n, bin);
  return (int)cudaGetLastError();
}
