// Hopper (sm_90a) kernels for the fused hinge loss and subgradient of a
// linear model over a batch.
//
// hinge_grad — replaces hinge_grad / _kernel
//              (src/repro/kernels/hinge_grad.py:34 and :57).
//   margin_b = y_b * <x_b, w>,  loss_b = max(1 - margin_b, 0),
//   g = (1/B) * sum_b coeff_b * x_b  with coeff_b = -y_b if margin_b < 1
//   else 0;  x (B, n) float32 row-major with n % 128 == 0, y (B,), w (n,).
//   Bound: bytes. x dominates (4*B*n B: 4.04 GB for the whole paper stream,
//   B = 99,968, n = 10,112, so 1.21 ms at 3.35 TB/s); the work is 4 flops
//   per element of x, far under the fp32 rate.
//   Design: the TPU kernel adds every batch block's contribution into ONE
//   output block of g across its sequential grid. On the card blocks run in
//   parallel, so that is a race, and float atomics would make g change from
//   run to run. Here a persistent grid (at most as many blocks as fit on
//   the 132 SMs at once) walks chunks of R rows; each block keeps its own
//   partial g of length n, and a second kernel sums the per-block partials
//   in block order and divides by B (a division, as the reference's g / B).
//   No atomics: the result is bit-stable.
//   One read of x: a block reads a chunk's R rows once with 16-byte loads,
//   computing the R dot products as it goes and keeping the rows in shared
//   memory; after a block-wide reduction gives the R margins, the gradient
//   pass adds coeff * x from shared memory into the block's partial g, which
//   also lives in shared memory. Every thread owns the same columns in both
//   passes, so the staged rows and the partial need no barrier of their own.
//   R = as many rows as fit beside the partial (4 at n = 10,112), fewer
//   when the batch is small, so that every SM gets a chunk. When not even
//   one row fits beside the partial (n > ~28,900) the kernel runs unstaged:
//   the partial sits in the block's row of the global scratch and the
//   gradient pass reads the chunk's rows again (they were just read, so
//   mostly from L2).
//
// Plain C interface: built with nvcc into a shared library and called
// through ctypes by src/repro_torch/kernels/hinge_grad.py, which casts the
// inputs to contiguous 16-byte-aligned float32, asks hg_plan for the chunk
// and grid sizes, allocates the (grid, n) scratch and the outputs, and
// passes PyTorch's current stream. Each entry point returns a CUDA error
// code (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;          // rows per chunk, at most
constexpr int kFinalThreads = 256;

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

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <int R, bool kStaged>
cudaError_t launch_rows(const float* x, const float* y, const float* w,
                        int64_t B, int n, int grid, size_t smem, float* loss,
                        float* margin, float* part, cudaStream_t s) {
  auto kernel = hinge_rows_kernel<R, kStaged>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, s>>>(
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

}  // namespace

extern "C" {

// The launch plan for a (B, n) batch on the current device: rows per chunk,
// grid size (the scratch is grid * n floats), whether the rows are staged
// in shared memory, and the dynamic shared memory in bytes.
int hg_plan(int64_t B, int n, int* rows, int* grid, int* staged,
            int64_t* smem) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
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
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int per = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads,
                                                      (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  if (per < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t chunks = cdiv(B, r);
  const int64_t full = (int64_t)sms * per;
  *rows = (int)r;
  *grid = (int)(chunks < full ? chunks : full);
  *staged = stage ? 1 : 0;
  *smem = bytes;
  return 0;
}

// x (B, n), y (B,), w (n,) float32, 16-byte aligned, n % 128 == 0, B >= 1;
// part (grid, n) scratch; outputs loss, margin (B,) and g (n,).
int hg_hinge_grad(const float* x, const float* y, const float* w, int64_t B,
                  int n, int rows, int grid, int staged, int64_t smem,
                  float* part, float* loss, float* margin, float* g,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      staged ? launch_rows_r<true>(rows, x, y, w, B, n, grid, (size_t)smem,
                                   loss, margin, part, s)
             : launch_rows_r<false>(rows, x, y, w, B, n, grid, 0, loss,
                                    margin, part, s);
  if (err != cudaSuccess) return (int)err;
  hinge_finalize_kernel<<<(unsigned)cdiv(n, kFinalThreads), kFinalThreads, 0,
                          s>>>(part, grid, n, (float)B, g);
  return (int)cudaGetLastError();
}

const char* hg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
