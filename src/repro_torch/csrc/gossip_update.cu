// Hopper (sm_90a) kernel for the gossip step's update of one node-stacked
// leaf: Laplace noise, ring mix, clipped OMD dual step and the L1 primal's
// zero count, in one pass.
//
// gossip_update — replaces no TPU kernel: the JAX reference runs
//   GossipDP.update (src/repro/core/gossip.py:171) as XLA ops, which XLA
//   fuses. It replaces the port's eager chain of ~20 torch ops a coordinate
//   (src/repro_torch/core/gossip.py, GossipDP.update's clip, mix, dual_step
//   and sparsity spans). For a leaf of m nodes of n coordinates, node i:
//     v     = max(u*span + lo, lo)            u: the leaf's torch.rand draw
//     tilde = theta + (-sign(v) * log1p(-2|v|)) * scale     (Laplace noise)
//     g     = grad * factor[i], rounded to grad's dtype     (per-node clip)
//     next  = ((sw*tilde[i] + nw*tilde[i-1]) + nw*tilde[i+1]) - alpha*g
//     zeros += [sign(next) * max(|next| - lam, 0) == 0]    (L1 primal zeros)
//   with ring indices mod m, as torch.roll has them (m = 1 and m = 2 too).
//   Bound: bytes. It reads theta (4 B), u (4 B) and grad (2 B bf16 or 4 B
//   f32) and writes next (4 B): 14 B a coordinate for a bf16 gradient, where
//   the eager chain moved ~260 B. The minicpm-2b embedding leaf of the
//   gossip benchmark (4 x 282.8 M coordinates) is 15.84 GB: 4.73 ms at
//   3.35 TB/s. ~25 flops a coordinate, far under the fp32 rate.
//   Design: one thread takes V = 4 coordinates (a float4; V = 1 when a
//   node's row is not 16-byte aligned) and walks the m nodes with a rolling
//   window (prev, cur, next) of noised rows, keeping node 0's and node m-1's
//   for the wrap, so every byte is read once for any m. Grid-stride over a
//   node's vectors, one resident wave of blocks; loads and the store are
//   streaming (__ldcs/__stcs: nothing is read twice). Each thread counts its
//   zeros, a block adds them by warp shuffles and shared memory, and one
//   thread a block adds the block's count to the update's int64 counter with
//   an atomic: an exact integer, whatever the order.
//   Rounding: every operation rounds on its own (__fmul_rn, __fadd_rn,
//   __fsub_rn: no contraction into a fused multiply-add; no fast math, so
//   log1pf is the CUDA math library's, as torch.log1p's kernel calls it) in
//   the eager ops' order, so next equals the eager chain bit for bit:
//   torch.rand's u, then u*span and +lo (two torch ops), clamp_min, sign,
//   neg, abs, *-2, log1p, the product, *scale, +theta; the clip's product in
//   f32 then rounded to bf16 (round to nearest even, as c10::BFloat16) and
//   back, as (grad * factor).to(grad.dtype) then .to(float32); the mix as
//   RingRollMixer.apply adds, (sw*x + nw*roll(x, 1)) + nw*roll(x, -1); alpha
//   times the gradient, subtracted. A torch op's scalar is a float32, so the
//   wrapper passes each scalar as the float32 torch would use.
//
// Plain C interface: built with nvcc into a shared library and called
// through ctypes by src/repro_torch/kernels/gossip_update.py, which checks
// shapes, dtypes and alignment, allocates next and passes PyTorch's current
// stream. The entry point returns cudaGetLastError() after its launch (0 =
// launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float span, lo, scale, sw, nw, alpha, lam;
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = __ldcs(p);
  }
}

// bf16 to f32 is exact: the 16 bits are the high half of the float
template <int V>
__device__ __forceinline__ void load(const uint16_t* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    x[0] = __uint_as_float(t.x << 16);
    x[1] = __uint_as_float(t.x & 0xffff0000u);
    x[2] = __uint_as_float(t.y << 16);
    x[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
    x[0] = __uint_as_float(static_cast<uint32_t>(__ldcs(p)) << 16);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else {
    __stcs(p, x[0]);
  }
}

// theta + scale * unit_laplace's transform of the uniform draw u
__device__ __forceinline__ float noised(float th, float u, const Scalars& s) {
  float v = __fadd_rn(__fmul_rn(u, s.span), s.lo);
  v = v < s.lo ? s.lo : v;                        // clamp_min: u is not NaN
  const float sg = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
  const float lap = __fmul_rn(-sg, log1pf(__fmul_rn(fabsf(v), -2.f)));
  return __fadd_rn(th, __fmul_rn(lap, s.scale));
}

template <int V>
__device__ __forceinline__ void tilde(const float* theta, const float* u,
                                      int64_t at, const Scalars& s,
                                      float (&x)[V]) {
  float th[V], uu[V];
  load<V>(theta + at, th);
  load<V>(u + at, uu);
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = noised(th[k], uu[k], s);
}

template <int V>
__device__ __forceinline__ void copy(float (&to)[V], const float (&from)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) to[k] = from[k];
}

__device__ __forceinline__ float clipped(float g, float f, bool bf16) {
  const float c = __fmul_rn(g, f);
  return bf16 ? __bfloat162float(__float2bfloat16_rn(c)) : c;
}

template <int V, typename G>
__global__ void __launch_bounds__(kThreads)
gossip_kernel(const float* __restrict__ theta, const float* __restrict__ u,
              const G* __restrict__ grad, const float* __restrict__ factor,
              Scalars s, int m, int64_t n, float* __restrict__ out,
              unsigned long long* __restrict__ zeros) {
  constexpr bool kBf16 = sizeof(G) == 2;
  const int64_t nv = n / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned long long count = 0;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < nv;
       e += stride) {
    const int64_t j = e * V;
    float last[V], first[V], prev[V], cur[V], nxt[V];
    tilde<V>(theta, u, (int64_t)(m - 1) * n + j, s, last);
    if (m == 1) copy<V>(first, last);
    else tilde<V>(theta, u, j, s, first);
    copy<V>(prev, last);
    copy<V>(cur, first);
    for (int i = 0; i < m; ++i) {
      const int64_t at = (int64_t)i * n + j;
      if (i + 1 == m) copy<V>(nxt, first);
      else if (i + 1 == m - 1) copy<V>(nxt, last);
      else tilde<V>(theta, u, at + n, s, nxt);
      float g[V], res[V];
      load<V>(grad + at, g);
      const float f = __ldg(factor + i);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float mixed = __fadd_rn(
            __fadd_rn(__fmul_rn(cur[k], s.sw), __fmul_rn(prev[k], s.nw)),
            __fmul_rn(nxt[k], s.nw));
        const float r =
            __fsub_rn(mixed, __fmul_rn(clipped(g[k], f, kBf16), s.alpha));
        res[k] = r;
        // the soft threshold is 0 where r is 0 or |r| - lam <= 0 (NaN: not)
        count += (r == 0.f) | (__fsub_rn(fabsf(r), s.lam) <= 0.f);
      }
      store<V>(out + at, res);
      copy<V>(prev, cur);
      copy<V>(cur, nxt);
    }
  }
  __shared__ unsigned long long warp_counts[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    if (total) atomicAdd(zeros, total);
  }
}

template <int V, typename G>
int launch(const float* theta, const float* u, const void* grad,
           const float* factor, const Scalars& s, int m, int64_t n,
           float* out, unsigned long long* zeros, cudaStream_t stream) {
  auto kernel = gossip_kernel<V, G>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t need = (n / V + kThreads - 1) / kThreads;
  const int64_t blocks = need < wave ? need : wave;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      theta, u, static_cast<const G*>(grad), factor, s, m, n, out, zeros);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// theta, u, out: (m, n) float32; grad: (m, n) bfloat16 (grad_bf16 = 1) or
// float32; factor: (m,) float32; zeros: one int64 the count is added to.
// vec = 4 needs n % 4 == 0 and every row 16-byte aligned (8 for a bf16
// grad); the wrapper checks both and passes vec = 1 otherwise. n >= 1.
int gu_gossip_update(const float* theta, const float* u, const void* grad,
                     int grad_bf16, const float* factor, int m, int64_t n,
                     int vec, float span, float lo, float scale, float sw,
                     float nw, float alpha, float lam, float* out,
                     unsigned long long* zeros, void* stream) {
  const Scalars s{span, lo, scale, sw, nw, alpha, lam};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return grad_bf16
        ? launch<4, uint16_t>(theta, u, grad, factor, s, m, n, out, zeros, st)
        : launch<4, float>(theta, u, grad, factor, s, m, n, out, zeros, st);
  return grad_bf16
      ? launch<1, uint16_t>(theta, u, grad, factor, s, m, n, out, zeros, st)
      : launch<1, float>(theta, u, grad, factor, s, m, n, out, zeros, st);
}

const char* gu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
