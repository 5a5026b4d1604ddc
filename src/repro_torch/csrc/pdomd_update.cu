// Hopper (sm_90a) kernel for the fused ring-gossip mix, OMD step and L1 prox
// on (rows, 128) parameter tiles.
//
// pdomd_update — replaces pdomd_update / _kernel
//                (src/repro/kernels/pdomd_update.py:36 and :49).
//   theta_new = sw*theta_self + nw*theta_prev + nw*theta_next - alpha*g
//   w         = sign(theta_new) * max(|theta_new| - lam, 0)
//   over the flat rows*128 elements of four (rows, 128) float32 inputs.
//   Bound: bytes. It reads four inputs and writes two outputs, 24 B per
//   element (15.36 MB at the paper's node stack, rows = 5,000: 4.6 us at
//   3.35 TB/s), for ~9 flops per element, far under the fp32 rate.
//   Design: the TPU kernel walks (block_rows, 128) VMEM blocks on a
//   sequential grid; nothing carries across blocks, so on the card it is one
//   grid-stride pass with 16-byte (float4) loads and stores, neighbouring
//   threads on neighbouring addresses, the four scalars passed by value.
//   Nothing is staged: every byte is touched once. Each operation rounds on
//   its own (__fmul_rn, __fadd_rn: no fused multiply-add), in the reference's
//   order, so the result equals the plain PyTorch version bit for bit.
//   sign(0) = 0 and NaN propagates, as jnp.sign and jnp.maximum have them.
//
// Plain C interface: built with nvcc into a shared library and called
// through ctypes by src/repro_torch/kernels/pdomd_update.py, which casts the
// inputs to contiguous 16-byte-aligned float32, allocates both outputs and
// passes PyTorch's current stream. The entry point returns
// cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float prox_l1(float t, float lam) {
  const float d = __fsub_rn(fabsf(t), lam);
  const float mag = d < 0.f ? 0.f : d;                      // NaN stays NaN
  const float s = t > 0.f ? 1.f : (t < 0.f ? -1.f : t);     // sign(0) = 0
  return __fmul_rn(s, mag);
}

__device__ __forceinline__ void step(float a, float b, float c, float g,
                                     float alpha, float lam, float sw,
                                     float nw, float& w, float& th) {
  const float mixed = __fadd_rn(__fadd_rn(__fmul_rn(sw, a), __fmul_rn(nw, b)),
                                __fmul_rn(nw, c));
  th = __fsub_rn(mixed, __fmul_rn(alpha, g));
  w = prox_l1(th, lam);
}

__global__ void __launch_bounds__(kThreads)
pdomd_kernel(const float4* __restrict__ self, const float4* __restrict__ prev,
             const float4* __restrict__ next, const float4* __restrict__ grad,
             float alpha, float lam, float sw, float nw, int64_t total4,
             float4* __restrict__ w_out, float4* __restrict__ theta_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total4;
       e += stride) {
    const float4 a = self[e], b = prev[e], c = next[e], g = grad[e];
    float4 w, th;
    step(a.x, b.x, c.x, g.x, alpha, lam, sw, nw, w.x, th.x);
    step(a.y, b.y, c.y, g.y, alpha, lam, sw, nw, w.y, th.y);
    step(a.z, b.z, c.z, g.z, alpha, lam, sw, nw, w.z, th.z);
    step(a.w, b.w, c.w, g.w, alpha, lam, sw, nw, w.w, th.w);
    theta_out[e] = th;
    w_out[e] = w;
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// total = rows * 128 elements (a multiple of 4); every pointer 16-byte
// aligned (the wrapper guarantees both).
int pu_pdomd_update(const float* self, const float* prev, const float* next,
                    const float* grad, float alpha, float lam, float sw,
                    float nw, int64_t total, float* w, float* theta_new,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total4 = total / 4;
  // enough blocks to fill 132 SMs several times over; the loop strides
  const int64_t blocks = cdiv(total4, kThreads) < 132 * 16
                             ? cdiv(total4, kThreads) : 132 * 16;
  pdomd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(self),
      reinterpret_cast<const float4*>(prev),
      reinterpret_cast<const float4*>(next),
      reinterpret_cast<const float4*>(grad), alpha, lam, sw, nw, total4,
      reinterpret_cast<float4*>(w), reinterpret_cast<float4*>(theta_new));
  return (int)cudaGetLastError();
}

const char* pu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
