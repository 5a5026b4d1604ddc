// Hopper (sm_90a) kernels for one round of private gossip OMD.
//
// Counterparts of the three Pallas TPU kernels in
// src/repro/kernels/round_fused.py. They compute what those kernels compute;
// the tiling is this card's own. Plain C interface: built with nvcc into a
// shared library and called through ctypes by
// src/repro_torch/kernels/round_fused.py, which allocates every output and
// scratch buffer and passes PyTorch's current stream. Each entry point
// returns cudaGetLastError() after its launches (0 = launched).
//
// Shapes: theta, x, delta, recv, mixed are (m, n) row-major float32; the
// per-node vectors coeff, diag, alive are (m,); A is (m, m). Ragged edges
// (n or m not a multiple of a tile) are masked here; nothing is padded.
//
// ---------------------------------------------------------------------------
// round_stats  — replaces round_stats / _stats_kernel
//                (src/repro/kernels/round_fused.py:95 and :130).
//   w = soft_threshold(theta, lam_t) (or theta), then per node
//   dot = sum w*x, xsq = sum x*x, nnz = sum [w != 0], wbdot = sum (wsum/m)*x
//   and per column wsum = sum_i w.
//   Bound: bytes. It reads theta and x once (8 B per element, 5.1 MB at
//   m=64, n=10,000) and does ~12 flops per element, far under the fp32 rate,
//   so the floor is 8*m*n B over 3.35 TB/s (about 1.5 us there).
//   Design: the Pallas body adds into re-visited output blocks, legal only on
//   the TPU's sequential grid. Here blocks run in parallel in no order, so
//   each block owns a 64-column tile and ALL m rows of it: it finishes its
//   wsum tile itself (no cross-block sum needed), then the per-row partials
//   [dot, xsq, nnz, wbdot] of its columns go to a (tiles, m, 4) scratch that
//   a second small kernel sums per row in a fixed order. No float atomics:
//   the result is bit-stable from run to run. nnz partials are exact small
//   integers in f32 (<= 64) and are summed as int32. Loads are coalesced
//   (a warp reads 32 neighbouring columns of one row); the wbdot pass
//   re-reads x, which at the main path's size is still in the 50 MB L2.
//
// round_update — replaces round_update / _update_kernel (:170 and :194).
//   tilde = theta + delta; r = recv (use_recv) or tilde; s = tilde
//   (noise_self) or theta; mixed = A @ r + diag*(s - r);
//   next = mixed - alpha*(coeff*x); dead rows keep theta.
//   Bound: bytes at the main path (m=64: reads theta, delta, x, writes next
//   and tilde, 12.8 MB, about 3.8 us; the product is 2*m*m*n = 82 MFLOP,
//   1.2 us at 67 TFLOP/s fp32). At m=1024 the fp32 product dominates.
//   Design: on the TPU the whole (m, m) A sits in VMEM; 1024^2 f32 = 4 MiB
//   does not fit in a block's 227 KB of shared memory. So the mix is a tiled
//   fp32 product: each 256-thread block owns a 64x64 output tile, walks k in
//   steps of 16 staging A^T and r slices in shared memory (8 KB), and keeps
//   a 4x4 register tile per thread with plain fp32 FMA (no TF32: the float
//   contract is 5e-6). r is formed on the fly from theta + delta, so tilde
//   is never read back; the noise-add, self correction, dual step and crash
//   freeze are the epilogue, so next is written once.
//
// dual_step    — replaces dual_step / _dual_kernel (:240 and :249).
//   next = mixed - alpha*(coeff*x), dead rows keep theta; elementwise.
//   Bound: bytes (reads mixed, x, theta, writes next: 16 B per element,
//   10.2 MB at the main path's shape, about 3.1 us).
//   Design: one grid-stride pass with coalesced loads; nothing is staged.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStatsCols = 64;        // columns per round_stats tile

constexpr int kBM = 64;               // round_update output tile rows
constexpr int kBN = 64;               //                      and columns
constexpr int kBK = 16;               // k-step of the staged product

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sign(t) * max(|t| - lam, 0), exactly as the reference writes it
__device__ __forceinline__ float soft_threshold(float t, float lam) {
  float a = fabsf(t) - lam;
  a = a > 0.f ? a : 0.f;
  return t > 0.f ? a : (t < 0.f ? -a : 0.f * a);
}

__global__ void __launch_bounds__(kThreads)
stats_tile_kernel(const float* __restrict__ theta, const float* __restrict__ x,
                  float lam_t, float m_real, int prox_l1, int m, int n,
                  float* __restrict__ partial, float* __restrict__ wsum) {
  __shared__ float red[kWarps][kStatsCols];
  __shared__ float wbar[kStatsCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int c0 = tile * kStatsCols + lane, c1 = c0 + 32;
  const bool in0 = c0 < n, in1 = c1 < n;

  float ws0 = 0.f, ws1 = 0.f;
  for (int i = warp; i < m; i += kWarps) {
    const float* th = theta + (size_t)i * n;
    const float* xr = x + (size_t)i * n;
    const float t0 = in0 ? th[c0] : 0.f, t1 = in1 ? th[c1] : 0.f;
    const float x0 = in0 ? xr[c0] : 0.f, x1 = in1 ? xr[c1] : 0.f;
    const float w0 = prox_l1 ? soft_threshold(t0, lam_t) : t0;
    const float w1 = prox_l1 ? soft_threshold(t1, lam_t) : t1;
    ws0 += w0;
    ws1 += w1;
    const float dot = warp_sum(w0 * x0 + w1 * x1);
    const float xsq = warp_sum(x0 * x0 + x1 * x1);
    const float nz = warp_sum((w0 != 0.f ? 1.f : 0.f) + (w1 != 0.f ? 1.f : 0.f));
    if (lane == 0) {
      float* p = partial + ((size_t)tile * m + i) * 4;
      p[0] = dot;
      p[1] = xsq;
      p[2] = nz;
    }
  }
  red[warp][lane] = ws0;
  red[warp][lane + 32] = ws1;
  __syncthreads();
  if (threadIdx.x < kStatsCols) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    const int c = tile * kStatsCols + threadIdx.x;
    if (c < n) wsum[c] = s;
    wbar[threadIdx.x] = s / m_real;   // 0 past the ragged edge
  }
  __syncthreads();
  const float wb0 = wbar[lane], wb1 = wbar[lane + 32];
  for (int i = warp; i < m; i += kWarps) {
    const float* xr = x + (size_t)i * n;
    const float x0 = in0 ? xr[c0] : 0.f, x1 = in1 ? xr[c1] : 0.f;
    const float wb = warp_sum(wb0 * x0 + wb1 * x1);
    if (lane == 0) partial[((size_t)tile * m + i) * 4 + 3] = wb;
  }
}

// one warp per node: sums that node's per-tile partials in tile order
__global__ void __launch_bounds__(kThreads)
stats_finalize_kernel(const float* __restrict__ partial, int tiles, int m,
                      float* __restrict__ dot, float* __restrict__ xsq,
                      int* __restrict__ nnz, float* __restrict__ wbdot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= m) return;                       // whole warp leaves together
  float s_dot = 0.f, s_xsq = 0.f, s_wb = 0.f;
  int s_nz = 0;
  for (int t = lane; t < tiles; t += 32) {
    const float4 p = *reinterpret_cast<const float4*>(
        partial + ((size_t)t * m + i) * 4);
    s_dot += p.x;
    s_xsq += p.y;
    s_nz += (int)p.z;
    s_wb += p.w;
  }
  s_dot = warp_sum(s_dot);
  s_xsq = warp_sum(s_xsq);
  s_nz = warp_sum_int(s_nz);
  s_wb = warp_sum(s_wb);
  if (lane == 0) {
    dot[i] = s_dot;
    xsq[i] = s_xsq;
    nnz[i] = s_nz;
    wbdot[i] = s_wb;
  }
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const float* __restrict__ A, const float* __restrict__ theta,
              const float* __restrict__ delta, const float* __restrict__ x,
              const float* __restrict__ recv, const float* __restrict__ coeff,
              const float* __restrict__ diag, const float* __restrict__ alive,
              float alpha, int use_recv, int noise_self, int m, int n,
              float* __restrict__ out, float* __restrict__ tilde_out) {
  // As holds A^T of the tile (As[k][row]); rows padded to keep float4 reads
  // 16-byte aligned and stores spread over banks
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ float Rs[kBK][kBN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;   // 16 x 16
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < m && gk < m) ? A[(size_t)gr * m + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, c = e % kBN;
      const int gk = k0 + k, gc = col0 + c;
      float v = 0.f;
      if (gk < m && gc < n) {
        const size_t idx = (size_t)gk * n + gc;
        v = use_recv ? recv[idx] : theta[idx] + delta[idx];
      }
      Rs[k][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Rs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
    const float cf = coeff[r], dg = diag[r];
    const bool live = alive[r] > 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= n) continue;
      const size_t idx = (size_t)r * n + c;
      const float th = theta[idx];
      const float tl = th + delta[idx];
      const float rv = use_recv ? recv[idx] : tl;
      const float s = noise_self ? tl : th;
      const float mixed = acc[i][j] + dg * (s - rv);
      const float nxt = mixed - alpha * (cf * x[idx]);
      out[idx] = live ? nxt : th;
      tilde_out[idx] = tl;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dual_kernel(const float* __restrict__ mixed, const float* __restrict__ x,
            const float* __restrict__ theta, const float* __restrict__ coeff,
            const float* __restrict__ alive, float alpha, int64_t m, int64_t n,
            float* __restrict__ out) {
  const int64_t total = m * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t r = e / n;
    const float nxt = mixed[e] - alpha * (coeff[r] * x[e]);
    out[e] = alive[r] > 0.f ? nxt : theta[e];
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// floats of scratch round_stats needs: (tiles, m, 4)
int64_t rf_stats_scratch_floats(int m, int n) {
  return cdiv(n, kStatsCols) * (int64_t)m * 4;
}

int rf_round_stats(const float* theta, const float* x, float lam_t,
                   float m_real, int prox_l1, int m, int n, float* scratch,
                   float* dot, float* xsq, int* nnz, float* wbdot,
                   float* wsum, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (int)cdiv(n, kStatsCols);
  stats_tile_kernel<<<tiles, kThreads, 0, s>>>(theta, x, lam_t, m_real,
                                               prox_l1, m, n, scratch, wsum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_finalize_kernel<<<(int)cdiv(m, kWarps), kThreads, 0, s>>>(
      scratch, tiles, m, dot, xsq, nnz, wbdot);
  return (int)cudaGetLastError();
}

int rf_round_update(const float* A, const float* theta, const float* delta,
                    const float* x, const float* recv, const float* coeff,
                    const float* diag, const float* alive, float alpha,
                    int use_recv, int noise_self, int m, int n, float* out,
                    float* tilde, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)cdiv(n, kBN), (unsigned)cdiv(m, kBM));
  update_kernel<<<grid, kThreads, 0, s>>>(A, theta, delta, x, recv, coeff,
                                          diag, alive, alpha, use_recv,
                                          noise_self, m, n, out, tilde);
  return (int)cudaGetLastError();
}

int rf_dual_step(const float* mixed, const float* x, const float* theta,
                 const float* coeff, const float* alive, float alpha, int m,
                 int n, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = (int64_t)m * n;
  // enough blocks to fill 132 SMs several times over; the loop strides
  const int64_t blocks = cdiv(total, kThreads) < 132 * 16
                             ? cdiv(total, kThreads) : 132 * 16;
  dual_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(mixed, x, theta, coeff,
                                                    alive, alpha, m, n, out);
  return (int)cudaGetLastError();
}

const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
