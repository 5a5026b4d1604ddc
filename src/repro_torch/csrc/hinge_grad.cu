// Hopper (sm_90a) kernels for the fused hinge loss and subgradient of a
// linear model over a batch.
//
// hinge_grad — replaces hinge_grad / _kernel
//              (src/repro/kernels/hinge_grad.py:34 and :57).
//   margin_b = y_b * <x_b, w>,  loss_b = max(1 - margin_b, 0),
//   g = (1/B) * sum_b coeff_b * x_b  with coeff_b = -y_b if margin_b < 1
//   else 0;  x (B, n) float32 row-major with n % 128 == 0, y (B,), w (n,).
//   Bound: bytes. x dominates (4*B*n B: 4.04 GB for the whole paper stream,
//   B = 99,968, n = 10,112, so 1.21 ms at 3.35 TB/s; 2.59 MB, 0.77 us, at
//   one ring round's B = 64); the work is 4 flops per element of x, far
//   under the fp32 rate.
//   The TPU kernel adds every batch block's contribution into ONE output
//   block of g across its sequential grid. On the card blocks run in
//   parallel, so that is a race, and float atomics would make g change from
//   run to run. Two paths, neither with float atomics (bit-stable), chosen
//   by hg_plan from B, n and the card alone (its SM count and what fits on
//   an SM):
//
//   * Slab path (B <= kSlabMaxRows): one cooperative launch, no scratch
//     the size of x, no memset. Split columns, not rows: a block owns a
//     slab of 32*C float4 columns across all B rows (lane l of every warp
//     takes columns l, l+32, ...; warp k takes rows k, k+nw, ...; nw =
//     min(B, 8) warps), so at n = 10,112 there are 79 slabs (C = 1, for
//     B = 1) or 40 (C = 2), and every SM that holds a slab streams even at
//     B = 1. Each thread issues all its loads of x, w and y at once into
//     registers (RT rows x C float4; nothing staged in shared memory),
//     reduces each row's partial dot over the slab with a butterfly across
//     the warp and writes the (B, slabs) partial dots. One grid barrier
//     (below); then EVERY block reads all the partial dots (each warp its
//     rows', every load in flight at once) and sums each row's in fixed
//     slab order (ascending slab per lane, then a butterfly), so all
//     blocks compute bit-identical margins: a tiny (B,) finalize in every
//     block, not one block reading a big one. Block 0 writes loss and
//     margin; each block writes its slab of g from the x still in its
//     registers: each thread adds its rows in ascending b with fmaf from 0,
//     the warps' sums are added in warp order, then __fdiv_rn by B (a
//     division, as the reference's g / B).
//     So x is read once and nothing of size n crosses blocks.
//     The grid barrier: the launch is cooperative, so the runtime refuses
//     it unless every block is resident at once. Thread 0 of each block
//     adds to an unsigned counter (atom.add.release) and spins until the
//     counter's top bit flips (ld.acquire): block 0 adds 2^31 - (grid - 1),
//     the others 1, so the arrivals of one launch add up to 2^31 and the
//     low 31 bits return to 0 — the counter needs no reset and no memset.
//     It is an int the wrapper owns per (device, stream), as round_stats'
//     ticket.
//     What bounds it: latency, not bytes. One launch of any kind costs the
//     card more than the 0.8 us that x takes at B = 64 (a torch.mv of the
//     same x and w takes longer than that bound; chip_smoke.py times it),
//     and within the launch the load of the slab, the barrier and the read
//     of the partial dots each wait about one memory round trip. The
//     partial dots are what grows with B: every block reads all B x slabs
//     of them, the same few KB. Tried on the card and slower (throwaway
//     variants, not kept): staging the tile in shared memory (bank
//     conflicts and serial loops over the staged rows), 127 slabs of 20
//     float4 (more partial dots for every block to read), owning whole
//     rows for the margins and re-reading the slab from L2 for g (one SM
//     per row reads a 40 KB row too slowly), and partial dots tagged with
//     a launch epoch and polled instead of a barrier (faster only at
//     B <= 2; at B = 64 the polling of every tagged partial cost more than
//     the barrier).
//     The crossover, kSlabMaxRows = 128: a thread holds 16 rows of its
//     slab in registers there (186 registers; 32 rows would not fit), and
//     the slab path still beats the row path at 128 rows (PERF.md;
//     tools/hinge_ab.py times both). Above it the row path's extra traffic
//     (grid x n floats of partial g, written and read again: ~10.7 MB at
//     n = 10,112) matters less and less against x.
//
//   * Row path (larger batches). A persistent grid (at most as many blocks
//     as fit on the 132 SMs at once) walks chunks of R rows; each block
//     keeps its own partial g of length n, and a second kernel sums the
//     per-block partials in block order and divides by B. One read of x: a
//     block reads a chunk's R rows once with 16-byte loads, computing the R
//     dot products as it goes and keeping the rows in shared memory; after
//     a block-wide reduction gives the R margins, the gradient pass adds
//     coeff * x from shared memory into the block's partial g, which also
//     lives in shared memory. Every thread owns the same columns in both
//     passes, so the staged rows and the partial need no barrier of their
//     own. R = as many rows as fit beside the partial (4 at n = 10,112),
//     fewer when the batch is small, so that every SM gets a chunk. When
//     not even one row fits beside the partial (n > ~28,900) the kernel
//     runs unstaged: the partial sits in the block's row of the global
//     scratch and the gradient pass reads the chunk's rows again (they were
//     just read, so mostly from L2).
//
// Plain C interface: built with nvcc into a shared library and called
// through ctypes by src/repro_torch/kernels/hinge_grad.py, which casts the
// inputs to contiguous 16-byte-aligned float32, asks hg_plan once per
// (device, B, n) for the path and launch shape, allocates the scratch and
// the outputs, and passes PyTorch's current stream. Each entry point
// returns a CUDA error code (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

// The launch plan (hg_plan fills it; the wrapper keeps it per device, B
// and n and hands it back to hg_hinge_grad).
struct HgPlan {
  int32_t path;     // kPathRowsUnstaged, kPathRowsStaged or kPathSlabs
  int32_t unit;     // row path: rows per chunk; slab path: rows per warp
  int32_t width;    // slab path: float4 columns per lane (C); row path: 0
  int32_t grid;     // blocks
  int32_t block;    // threads per block
  int32_t pad;
  int64_t smem;     // dynamic shared memory, bytes
  int64_t scratch;  // floats of scratch: the (B, slabs) partial dots, or
                    // the row path's (grid, n) partial g
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;          // rows per chunk, at most
constexpr int kFinalThreads = 256;

constexpr int kSlabMaxRows = 128;    // the slab path's largest batch (header)
constexpr int kSlabWarps = 8;        // warps of a slab block, at most
constexpr int kDotLoads = 4;         // partial dots a lane loads at once

constexpr int kPathRowsUnstaged = 0;
constexpr int kPathRowsStaged = 1;
constexpr int kPathSlabs = 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float c, float4 x, float4 a) {
  return make_float4(fmaf(c, x.x, a.x), fmaf(c, x.y, a.y),
                     fmaf(c, x.z, a.z), fmaf(c, x.w, a.w));
}

// kStaged: the partial (n4 float4) and the chunk's rows (R * n4 float4) live
// in dynamic shared memory; else the partial is the block's row of `part`
// and the gradient pass re-reads x.
template <int R, bool kStaged>
__global__ void __launch_bounds__(kThreads)
hinge_rows_kernel(const float4* __restrict__ x, const float* __restrict__ y,
                  const float4* __restrict__ w, int64_t B, int n4,
                  float* __restrict__ loss, float* __restrict__ margin,
                  float* __restrict__ part) {
  extern __shared__ float4 smem[];
  __shared__ float red[R][kWarps];
  __shared__ float coeff_s[R];
  float4* const part4 =
      reinterpret_cast<float4*>(part) + (int64_t)blockIdx.x * n4;
  float4* const acc = kStaged ? smem : part4;
  float4* const rows = smem + n4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < n4; j += kThreads) acc[j] = make_float4(0, 0, 0, 0);

  const int64_t chunks = (B + R - 1) / R;
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int64_t r0 = c * R;
    const int rr = (int)(B - r0 < R ? B - r0 : R);
    const float4* const xc = x + r0 * n4;

    // pass 1: the R dot products, staging the rows as they go by
    float dot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dot[r] = 0.f;
    for (int j = tid; j < n4; j += kThreads) {
      const float4 wv = w[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rr) {
          const float4 xv = xc[(int64_t)r * n4 + j];
          if (kStaged) rows[r * n4 + j] = xv;
          dot[r] = dot4(xv, wv, dot[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = warp_sum(dot[r]);
      if (lane == 0) red[r][warp] = v;
    }
    __syncthreads();
    if (tid < rr) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += red[tid][k];   // fixed order
      const float yv = y[r0 + tid];
      const float mg = yv * s;
      const float d = 1.f - mg;
      margin[r0 + tid] = mg;
      loss[r0 + tid] = d < 0.f ? 0.f : d;                 // NaN stays NaN
      coeff_s[tid] = mg < 1.f ? -yv : 0.f;
    }
    __syncthreads();
    float cf[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cf[r] = r < rr ? coeff_s[r] : 0.f;

    // pass 2: this chunk's coeff * x into the block's partial g
    for (int j = tid; j < n4; j += kThreads) {
      float4 a = acc[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rr) {
          const float4 xv = kStaged ? rows[r * n4 + j]
                                    : xc[(int64_t)r * n4 + j];
          a = axpy4(cf[r], xv, a);
        }
      }
      acc[j] = a;
    }
  }
  if (kStaged)
    for (int j = tid; j < n4; j += kThreads) part4[j] = acc[j];
}

// g[j] = (sum over the grid's partials, in block order) / B
__global__ void __launch_bounds__(kFinalThreads)
hinge_finalize_kernel(const float* __restrict__ part, int blocks, int n,
                      float B, float* __restrict__ g) {
  const int j = blockIdx.x * kFinalThreads + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s += part[(int64_t)k * n + j];
  g[j] = __fdiv_rn(s, B);
}

// A barrier across the whole (cooperatively launched, so resident) grid;
// see the header for why `counter` needs no reset.
__device__ __forceinline__ void grid_barrier(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1u) : 1u;
    unsigned int old, now;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(counter), "r"(add) : "memory");
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(now) : "l"(counter) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0u);
  }
  __syncthreads();
}

// RT rows per warp (warp k: rows k, k+nw, ...), C float4 columns per lane;
// part is the (B, slabs) partial dots.
template <int RT, int C>
__global__ void __launch_bounds__(32 * kSlabWarps)
hinge_slabs_kernel(const float4* __restrict__ x, const float* __restrict__ y,
                   const float4* __restrict__ w, int B, int n4,
                   float* __restrict__ loss, float* __restrict__ margin,
                   float4* __restrict__ g, float* __restrict__ part,
                   unsigned int* __restrict__ counter) {
  __shared__ float4 gsum[kSlabWarps][32 * C];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int slabs = gridDim.x, c0 = blockIdx.x * 32 * C;

  // every load of the slab at once: x's rows, w, y
  float4 wv[C], xv[RT][C];
  float yv[RT];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = c0 + 32 * c + lane;
    wv[c] = col < n4 ? w[col] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int b = warp + nw * r;
    yv[r] = b < B ? y[b] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c0 + 32 * c + lane;
      xv[r][c] = b < B && col < n4 ? x[(int64_t)b * n4 + col]
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // each row's partial dot over the slab, a butterfly across the warp
  float d[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    d[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) d[r] = dot4(xv[r][c], wv[c], d[r]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < RT; ++r)
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], off);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int b = warp + nw * r;
      if (b < B) part[(int64_t)b * slabs + blockIdx.x] = d[r];
    }

  grid_barrier(counter);

  // each row's dot: its partial dots in fixed slab order (ascending in
  // each lane, then a butterfly), the same in every block
#pragma unroll
  for (int r = 0; r < RT; ++r) d[r] = 0.f;
  for (int k0 = 0; k0 < slabs; k0 += 32 * kDotLoads) {
    float pv[RT][kDotLoads];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int b = warp + nw * r;
#pragma unroll
      for (int k = 0; k < kDotLoads; ++k) {
        const int s = k0 + 32 * k + lane;
        pv[r][k] = b < B && s < slabs ? __ldcg(part + (int64_t)b * slabs + s)
                                      : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int k = 0; k < kDotLoads; ++k) d[r] += pv[r][k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < RT; ++r)
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], off);

  // margins and coefficients; this slab of g from the rows in registers
  float cf[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int b = warp + nw * r;
    const float mg = yv[r] * d[r];
    cf[r] = b < B && mg < 1.f ? -yv[r] : 0.f;
    if (b < B && blockIdx.x == 0 && lane == 0) {
      const float dd = 1.f - mg;
      margin[b] = mg;
      loss[b] = dd < 0.f ? 0.f : dd;                     // NaN stays NaN
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < RT; ++r) a = axpy4(cf[r], xv[r][c], a);
    gsum[warp][32 * c + lane] = a;
  }
  __syncthreads();
  const float fb = (float)B;
  for (int j = threadIdx.x; j < 32 * C; j += blockDim.x) {
    const int col = c0 + j;
    float4 a = gsum[0][j];
    for (int k = 1; k < nw; ++k) {
      const float4 v = gsum[k][j];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    if (col < n4)
      g[col] = make_float4(__fdiv_rn(a.x, fb), __fdiv_rn(a.y, fb),
                           __fdiv_rn(a.z, fb), __fdiv_rn(a.w, fb));
  }
}

const void* slabs_kernel_ptr(int rt, int c) {
  switch (rt * 4 + c) {
    case 1 * 4 + 1: return (const void*)hinge_slabs_kernel<1, 1>;
    case 1 * 4 + 2: return (const void*)hinge_slabs_kernel<1, 2>;
    case 2 * 4 + 1: return (const void*)hinge_slabs_kernel<2, 1>;
    case 2 * 4 + 2: return (const void*)hinge_slabs_kernel<2, 2>;
    case 4 * 4 + 1: return (const void*)hinge_slabs_kernel<4, 1>;
    case 4 * 4 + 2: return (const void*)hinge_slabs_kernel<4, 2>;
    case 8 * 4 + 1: return (const void*)hinge_slabs_kernel<8, 1>;
    case 8 * 4 + 2: return (const void*)hinge_slabs_kernel<8, 2>;
    case 16 * 4 + 1: return (const void*)hinge_slabs_kernel<16, 1>;
    default: return nullptr;
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <int R, bool kStaged>
cudaError_t launch_rows(const float* x, const float* y, const float* w,
                        int64_t B, int n, int grid, size_t smem, float* loss,
                        float* margin, float* part, cudaStream_t s) {
  hinge_rows_kernel<R, kStaged><<<grid, kThreads, smem, s>>>(
      reinterpret_cast<const float4*>(x), y,
      reinterpret_cast<const float4*>(w), B, n / 4, loss, margin, part);
  return cudaGetLastError();
}

template <bool kStaged>
cudaError_t launch_rows_r(int rows, const float* x, const float* y,
                          const float* w, int64_t B, int n, int grid,
                          size_t smem, float* loss, float* margin,
                          float* part, cudaStream_t s) {
  switch (rows) {
    case 1: return launch_rows<1, kStaged>(x, y, w, B, n, grid, smem, loss, margin, part, s);
    case 2: return launch_rows<2, kStaged>(x, y, w, B, n, grid, smem, loss, margin, part, s);
    case 3: return launch_rows<3, kStaged>(x, y, w, B, n, grid, smem, loss, margin, part, s);
    case 4: return launch_rows<4, kStaged>(x, y, w, B, n, grid, smem, loss, margin, part, s);
    case 5: return launch_rows<5, kStaged>(x, y, w, B, n, grid, smem, loss, margin, part, s);
    case 6: return launch_rows<6, kStaged>(x, y, w, B, n, grid, smem, loss, margin, part, s);
    case 7: return launch_rows<7, kStaged>(x, y, w, B, n, grid, smem, loss, margin, part, s);
    case 8: return launch_rows<8, kStaged>(x, y, w, B, n, grid, smem, loss, margin, part, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kStaged>
const void* rows_kernel_ptr(int rows) {
  switch (rows) {
    case 1: return (const void*)hinge_rows_kernel<1, kStaged>;
    case 2: return (const void*)hinge_rows_kernel<2, kStaged>;
    case 3: return (const void*)hinge_rows_kernel<3, kStaged>;
    case 4: return (const void*)hinge_rows_kernel<4, kStaged>;
    case 5: return (const void*)hinge_rows_kernel<5, kStaged>;
    case 6: return (const void*)hinge_rows_kernel<6, kStaged>;
    case 7: return (const void*)hinge_rows_kernel<7, kStaged>;
    default: return (const void*)hinge_rows_kernel<8, kStaged>;
  }
}

// Let `kernel` take `bytes` of dynamic shared memory (never lowering what an
// earlier plan allowed it), and say how many of its blocks fit on an SM.
cudaError_t fit_kernel(const void* kernel, int threads, int64_t bytes,
                       int* per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && bytes > attr.maxDynamicSharedSizeBytes)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads,
                                                        (size_t)bytes);
  return err;
}

// The slab path's plan for B <= kSlabMaxRows, if every slab can be resident
// at once: C = 1 for one row (more, thinner slabs), else 2 (fewer partial
// dots for every block to read), 1 again where a thread holds 16 rows.
cudaError_t plan_slabs(int64_t B, int n, int sms, HgPlan* p, bool* ok) {
  *ok = false;
  const int nw = B < kSlabWarps ? (int)B : kSlabWarps;
  int rt = 1;
  while (rt * nw < B) rt *= 2;
  const int64_t n4 = n / 4;
  for (int c = B > 1 && rt < 16 ? 2 : 1; c <= 2; ++c) {
    const void* kernel = slabs_kernel_ptr(rt, c);
    if (kernel == nullptr) break;
    int per = 0;
    cudaError_t err = fit_kernel(kernel, 32 * nw, 0, &per);
    if (err != cudaSuccess) return err;
    const int64_t slabs = cdiv(n4, 32 * c);
    if (slabs <= (int64_t)sms * per) {
      *p = HgPlan{kPathSlabs, rt, c, (int)slabs, 32 * nw, 0, 0, B * slabs};
      *ok = true;
      break;
    }
  }
  return cudaSuccess;
}

cudaError_t launch_slabs(const float* x, const float* y, const float* w,
                         int B, int n, const HgPlan& p, float* loss,
                         float* margin, float* g, float* part,
                         unsigned int* counter, cudaStream_t s) {
  const void* kernel = slabs_kernel_ptr(p.unit, p.width);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4* g4 = reinterpret_cast<float4*>(g);
  int n4 = n / 4;
  void* args[] = {&x4, &y, &w4, &B, &n4, &loss, &margin, &g4, &part,
                  &counter};
  return cudaLaunchCooperativeKernel(kernel, dim3(p.grid), dim3(p.block),
                                     args, 0, s);
}

}  // namespace

extern "C" {

// The launch plan for a (B, n) batch on the current device, from B, n and
// the device alone (its SM count and what fits on an SM).
int hg_plan(int64_t B, int n, HgPlan* plan) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (B <= kSlabMaxRows) {
    bool ok = false;
    err = plan_slabs(B, n, sms, plan, &ok);
    if (err != cudaSuccess) return (int)err;
    if (ok) return 0;
  }

  const int64_t row_bytes = (int64_t)n * 4;
  // static shared memory of the kernel (red, coeff_s) and some headroom
  const int64_t budget = (int64_t)optin - 2048;
  const int64_t fit = budget / row_bytes - 1;        // rows beside the partial
  int64_t per_sm = cdiv(B, sms);                     // every SM gets a chunk
  if (per_sm < 1) per_sm = 1;
  int64_t r = per_sm < kMaxRows ? per_sm : kMaxRows;
  const bool stage = fit >= 1;
  if (stage && r > fit) r = fit;
  const int64_t bytes = stage ? (r + 1) * row_bytes : 0;
  const void* kernel = stage ? rows_kernel_ptr<true>((int)r)
                             : rows_kernel_ptr<false>((int)r);
  int per = 0;
  err = fit_kernel(kernel, kThreads, bytes, &per);
  if (err != cudaSuccess) return (int)err;
  if (per < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t chunks = cdiv(B, r);
  const int64_t full = (int64_t)sms * per;
  const int grid = (int)(chunks < full ? chunks : full);
  *plan = HgPlan{stage ? kPathRowsStaged : kPathRowsUnstaged, (int)r, 0,
                 grid, kThreads, 0, bytes, (int64_t)grid * n};
  return 0;
}

// x (B, n), y (B,), w (n,) float32, 16-byte aligned, n % 128 == 0, B >= 1;
// plan from hg_plan for this (B, n) on this device; part: the plan's
// scratch; counter: the slab path's barrier counter (an unsigned int, zero
// when first used; unused on the row path); outputs loss, margin (B,) and
// g (n,), g 16-byte aligned.
int hg_hinge_grad(const float* x, const float* y, const float* w, int64_t B,
                  int n, const HgPlan* plan, float* part,
                  unsigned int* counter, float* loss, float* margin,
                  float* g, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HgPlan& p = *plan;
  if (p.path == kPathSlabs)
    return (int)launch_slabs(x, y, w, (int)B, n, p, loss, margin, g, part,
                             counter, s);
  cudaError_t err =
      p.path == kPathRowsStaged
          ? launch_rows_r<true>(p.unit, x, y, w, B, n, p.grid,
                                (size_t)p.smem, loss, margin, part, s)
          : launch_rows_r<false>(p.unit, x, y, w, B, n, p.grid, 0, loss,
                                 margin, part, s);
  if (err != cudaSuccess) return (int)err;
  hinge_finalize_kernel<<<(unsigned)cdiv(n, kFinalThreads), kFinalThreads, 0,
                          s>>>(part, p.grid, n, (float)B, g);
  return (int)cudaGetLastError();
}

const char* hg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
