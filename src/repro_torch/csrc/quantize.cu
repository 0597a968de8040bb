// Fused uniform quantization: one read of x, three writes.
//
// Replaces the TPU kernel `_quantize_kernel` / `quantize_fused_fwd`
// (src/repro/kernels/quantize/kernel.py:25, :34).  x is float32 or
// bfloat16, read as float32, as the TPU kernel reads it.  For every element:
//   q    = round_half_even(x / bin)      int32
//   deq  = (float)q * bin                stored in x's dtype
//   err2 = (x - deq)^2                   float32, from the float32 deq
//
// Bound on the H100: bytes.  Each element moves 16 bytes in float32 (4
// read, 12 written; 12 in bfloat16) for a handful of flops, far below the card's ratio of flops to
// bytes, so the kernel is a grid-stride loop over a flat view that keeps
// neighbouring threads on neighbouring addresses and does nothing else.
//
// Numerics match the reference bit for bit: true IEEE division
// (__fdiv_rn, never a multiply by 1/bin, which moves half-way points into
// the other bin), rintf (round half to even, as jnp.round and torch.round),
// and explicit _rn intrinsics so the compiler cannot contract
// x - q*bin into one FMA, which would skip the rounding of deq.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);     // round to nearest even, as torch's .to
}

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                int* __restrict__ q,
                                T* __restrict__ deq,
                                float* __restrict__ err2,
                                long long n, float bin) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float xi = to_f32(x[i]);
    float qf = rintf(__fdiv_rn(xi, bin));
    float d = __fmul_rn(qf, bin);
    float e = __fsub_rn(xi, d);
    q[i] = (int)qf;
    deq[i] = from_f32<T>(d);
    err2[i] = __fmul_rn(e, e);
  }
}

template <typename T>
static int launch(const T* x, int* q, T* deq, float* err2, long long n,
                  float bin, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride past 16 blocks/SM
  quantize_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      x, q, deq, err2, n, bin);
  return (int)cudaGetLastError();
}

extern "C" int quantize_f32(const float* x, int* q, float* deq, float* err2,
                            long long n, float bin, cudaStream_t stream) {
  return launch(x, q, deq, err2, n, bin, stream);
}

extern "C" int quantize_bf16(const __nv_bfloat16* x, int* q,
                             __nv_bfloat16* deq, float* err2, long long n,
                             float bin, cudaStream_t stream) {
  return launch(x, q, deq, err2, n, bin, stream);
}
