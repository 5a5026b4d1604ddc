// Hopper (sm_90a) kernels for one round of private gossip OMD.
//
// Counterparts of the three Pallas TPU kernels in
// src/repro/kernels/round_fused.py. They compute what those kernels compute;
// the tiling is this card's own. Plain C interface: built with nvcc into a
// shared library and called through ctypes by
// src/repro_torch/kernels/round_fused.py, which allocates every output and
// scratch buffer and passes PyTorch's current stream. Each entry point
// returns cudaGetLastError() after its launch (0 = launched).
//
// Shapes: theta, x, delta, recv, mixed are (m, n) row-major float32; the
// per-node vectors coeff, diag, alive are (m,); A is (m, m); the CSR form of
// A is indptr (m+1,) int32, indices (nnz,) int32 (ascending in each row) and
// weights (nnz,) float32. Ragged edges are masked here; nothing is padded.
// Seed axis: round_stats and round_update take S independent runs (seeds) of
// one configuration in one launch. Their per-seed arrays are stacked, seed
// after seed: theta, x, delta, recv, out, tilde (S, m, n); dot, xsq, nnz,
// wbdot, coeff, alive (S, m); wsum (S, n). A, its CSR form and diag are
// shared (the seeds share one mixer). The seed is a grid axis (round_stats
// and the sparse round_update: blockIdx.y; the dense round_update:
// blockIdx.z), and each seed's blocks do exactly what an S = 1 launch does
// on that seed's rows, in the same order, so every seed's outputs equal an
// S = 1 launch's bit for bit. S = 1 is the unbatched call. A block moves its
// pointers to its seed's arrays only when its seed is not 0: unguarded, the
// offsets cost an S = 1 launch 1-4 % on the card (more registers in the
// dense round_update, tools/round_ab.py in turns against the kernels
// without a seed axis); guarded, 1 %.
// The schedule scalars lam_t (round_stats) and alpha (round_update) come by
// value, or, when the caller passes a non-null pointer beside the value,
// from one float in device memory: a round captured in a CUDA graph reads
// them from its row of the run's constants table
// (src/repro_torch/api/round_graph.py), so one capture serves every round.
// The arithmetic is the same f32 either way.
// `vec` = 4 when n % 4 == 0 and every (m, n) pointer is 16-byte aligned (the
// wrapper decides): rows are then read and written as float4; else 1.
//
// The "slab" used by round_stats and the sparse round_update: a block of 512
// threads owns W units (float4 or float) of columns across ALL m rows, so
// the column sums and a node's ring neighbours are in the block.
//
// ---------------------------------------------------------------------------
// round_stats  — replaces round_stats / _stats_kernel
//                (src/repro/kernels/round_fused.py:95 and :130).
//   w = soft_threshold(theta, lam_t) (or theta), then per node
//   dot = sum w*x, xsq = sum x*x, nnz = sum [w != 0], wbdot = sum (wsum/m)*x
//   and per column wsum = sum_i w.
//   Bound: bytes (theta and x read once, 5.1 MB at m=64, n=10,000: 1.54 us
//   at 3.35 TB/s; ~12 flops per element). At this size it is latency-bound:
//   each SM streams a few tens of KB, so the design is about waiting out one
//   HBM latency per block, not one per row.
//   Design, one launch of kStatsBlocks = 88 slab blocks (W = 29 float4 units
//   at the main path; 132 blocks gave a longer finalize, 66 and 44 a longer
//   load, on the card). Each block puts every 16-byte cp.async of its slab of
//   theta, then of x, in flight at once into shared memory; the per-column
//   sums of w run (S row segments per column, then the segments in order)
//   while x lands; wbar = wsum/m goes to shared memory; then P lanes per row
//   sum dot, xsq, nnz and wbdot from the staged tile and a butterfly over the
//   P lanes adds them. So theta and x are read from HBM once. Where the slab
//   does not fit in kStageBytes (m*W*V*8 B; e.g. at the fused cap m=1,024),
//   rows go in chunks of RC: the column pass stages theta, and the row pass
//   stages theta again with x (stats_kernel, the `!single` branches).
//   Finalize in the same launch: each block writes its (m, 4) per-row
//   partials; after a barrier its thread 0 runs __threadfence() and takes a
//   ticket with atomicAdd on an int counter; the block that draws the last
//   ticket sums all partials in a fixed order (thread group g adds tiles g,
//   g+G, ... in ascending order, 16 loads in flight, then groups 0..G-1 in
//   order; G = 512/m) and resets the counter to 0 for the next call. No
//   float atomics: results are bit-stable from run to run; nnz is an exact
//   int32 count. Each seed has its own counter and its own (blocks, m)
//   partials, so a seed's last block finalizes that seed alone. The
//   counters are an (S_max,) int32 array the wrapper allocates once per
//   (device, stream), zeroed, and grows (zeroed) when S grows, so calls on
//   two streams never share one and calls on one stream run in order; a
//   captured round passes its own, so two graphs never share one.
//   What still bounds it: the finalize. The fence and ticket cost about a
//   microsecond, and the last block then reads blocks x m x 16 B of partials
//   (89 KB at m=64) through one SM after the whole grid has finished. Below
//   those, a launch of this size costs ~2 us over its bytes on this card.
//   Tried and slower on the card: pre-summing partials across thread-block
//   clusters (the clusters' co-scheduling delayed the grid), and reading
//   the partials with one TMA bulk copy.
//
// round_update — replaces round_update / _update_kernel (:170 and :194).
//   tilde = theta + delta; r = recv (use_recv) or tilde; s = tilde
//   (noise_self) or theta; mixed = A @ r + diag*(s - r);
//   next = mixed - alpha*(coeff*x); dead rows keep theta.
//   Bound: bytes at the main path (reads theta, delta, x, writes next and
//   tilde, 12.8 MB, 3.8 us). Two paths, chosen by the caller:
//   With S seeds the grid is S times the S = 1 grid (W stays that of one
//   seed): 132 S slab blocks at the main path, each seed's on its own rows.
//   * sparse (update_sparse_kernel), when the wrapper is given A's CSR form.
//     The backend passes it when no row of the fixed graph holds more than
//     16 non-zeros (SPARSE_MAX_ROW_NNZ in the wrapper; the ring has 3).
//     Per float4 of output and per non-zero the sparse loop issues one
//     16-byte shared load, two broadcast loads of the CSR and 4 FMAs (~1.75
//     instructions per FMA) where the dense tile spends ~1.1 per FMA but
//     does m of them, so it wins while nnz per row < ~0.6 m; 16 keeps it
//     there from m = 27 up, and below that both are tiny and bytes-bound.
//     Design: a slab per block; W = ceil(units / 132) puts one block on
//     each of the 132 SMs at the main path (2,500 float4 units, W = 19).
//     Every thread holds up to 4 units in registers: it issues all its
//     float4 loads of theta, delta, x (and recv) at once, then, while they
//     fly, loads its rows' coeff/diag/alive and the block stages the CSR
//     form in shared memory (up to kCsrRows rows and kCsrNnz non-zeros;
//     above, the CSR is read from global memory); it writes tilde, puts r
//     in shared memory, and after ONE barrier sums its row's non-zeros in
//     ascending column order with fmaf from 0, reading neighbours' r from
//     shared memory. Each element is read from HBM once and next and tilde
//     are written once. The slab holds all m rows in registers, so this
//     path takes m <= 2,048 (the fused mode stops at 1,024).
//     fmaf(0, r, acc) == acc for finite r, so on the same A it equals the
//     dense path bit for bit (up to the sign of a zero).
//     What still bounds it: one block per SM loads, then stores, so the
//     store phase does not overlap the load phase, and the launch costs
//     ~2 us over the bytes (as for dual_step).
//   * dense (update_dense_kernel), given only A: a tiled fp32 product in
//     ascending k with plain FMA (no TF32: the float contract is 5e-6).
//     64x32 output tile per 128-thread block (4x4 registers per thread), so
//     m=64, n=10,000 is 313 blocks resident at once on 132 SMs (no second
//     wave); k-steps of 16 double-buffered through shared memory with
//     cp.async, the next step's A^T (transposed by 4-byte copies) and r
//     slices loading while the current one computes. r = theta + delta is
//     formed in shared memory by the thread that copied it. The epilogue
//     reads theta, delta and x of its tile (theta and delta from L2).
//     What bounds it: at m=64 the ragged spread of 313 tiles over 132 SMs
//     (2 or 3 each); at m=1,024 the fp32 FMA rate.
//   Both paths share one epilogue (finish) with explicit fmaf, so they
//   round alike: noise-add, self correction, dual step, crash freeze. The
//   dual step rounds after each operation (dual), as torch ops do.
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

constexpr int kSMs = 132;                          // H100 SXM
constexpr int kSlabThreads = 512;                  // slab kernels' block
constexpr int kMaxE = 4;                           // units a thread holds
constexpr int kSlabUnits = kSlabThreads * kMaxE;   // units a block stages
constexpr int kMaxSlabCols = kSlabThreads;         // W*V: a column a thread
constexpr int kStatsBlocks = 88;    // round_stats' grid where n allows
constexpr int kStageBytes = 160 * 1024;   // its staged rows of theta and x
constexpr int kCsrRows = 1024;   // sparse round_update stages its CSR form
constexpr int kCsrNnz = 1280;    // in shared memory up to these sizes

constexpr int kDM = 64;       // dense round_update output tile rows
constexpr int kDN = 32;       //                          and columns
constexpr int kDK = 16;       // k-step of the staged product
constexpr int kDThreads = 128;

constexpr int kThreads = 256;  // dual_step

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> zero_vec() {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = 0.f;
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* __restrict__ p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const Vec<V>& a) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2],
                                                 a.v[3]);
  } else {
    *p = a.v[0];
  }
}

template <int V>
__device__ __forceinline__ Vec<V> shared_vec(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

// Every load of this thread's units of rows [r0, r0 + rows) of the slab
// starting at unit u0, issued together; units past the slab or the ragged
// edge read as 0.
template <int V>
__device__ __forceinline__ void load_slab(const float* __restrict__ src,
                                          int r0, int rows, int u0, int W,
                                          int units, int n,
                                          Vec<V> (&out)[kMaxE]) {
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    const int q = threadIdx.x + e * kSlabThreads;
    const int row = q / W, u = u0 + q % W;
    out[e] = (q < rows * W && u < units)
                 ? load_vec<V>(src + (size_t)(r0 + row) * n + (size_t)u * V)
                 : zero_vec<V>();
  }
}

// a round's schedule scalar (lam_t, alpha_t): read from device memory when
// the caller passes a pointer (a captured round reads its row of the run's
// constants table), else the value passed; the same f32 either way
__device__ __forceinline__ float scalar(const float* __restrict__ p,
                                        float v) {
  return p ? __ldg(p) : v;
}

// sign(t) * max(|t| - lam, 0), exactly as the reference writes it
__device__ __forceinline__ float soft_threshold(float t, float lam) {
  float a = fabsf(t) - lam;
  a = a > 0.f ? a : 0.f;
  return t > 0.f ? a : (t < 0.f ? -a : 0.f * a);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Copy rows [r0, r0 + rows) of this block's W units of an (m, n) array into
// dst ([rows][W * V] floats) with cp.async, every copy in flight at once;
// units past the ragged edge are zero-filled. The caller commits and waits.
template <int V>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int r0, int rows, int u0, int W,
                                           int units, int n) {
  for (int q = threadIdx.x; q < rows * W; q += kSlabThreads) {
    const int r = q / W, u = u0 + q % W;
    const bool ok = u < units;
    const float* g = ok ? src + (size_t)(r0 + r) * n + (size_t)u * V : src;
    if constexpr (V == 4)
      cp_async16(dst + q * 4, g, ok);
    else
      cp_async4(dst + q, g, ok);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float4 shfl_xor4(const float4& a, int off) {
  return make_float4(__shfl_xor_sync(0xffffffffu, a.x, off),
                     __shfl_xor_sync(0xffffffffu, a.y, off),
                     __shfl_xor_sync(0xffffffffu, a.z, off),
                     __shfl_xor_sync(0xffffffffu, a.w, off));
}

template <int V>
__global__ void __launch_bounds__(kSlabThreads)
stats_kernel(const float* __restrict__ theta, const float* __restrict__ x,
             const float* __restrict__ lam_p, float lam_v, float m_real,
             int prox_l1, int m, int n, int units,
             int W, int RC, float4* __restrict__ partial,
             unsigned* __restrict__ counter, float* __restrict__ dot,
             float* __restrict__ xsq, int* __restrict__ nnz,
             float* __restrict__ wbdot, float* __restrict__ wsum) {
  // theta and x of RC rows of the slab, [RC][W * V] floats each
  extern __shared__ __align__(16) float stage[];
  __shared__ float seg[kSlabThreads];
  __shared__ __align__(16) float wbar[kMaxSlabCols];
  __shared__ float4 fin[kSlabThreads];
  __shared__ int s_last;
  const int tid = threadIdx.x, tile = blockIdx.x, u0 = tile * W;
  const int cols = W * V;
  if (blockIdx.y) {  // seed > 0: its rows, partials, counter, outputs
    const size_t seed = blockIdx.y;
    theta += seed * m * n;
    x += seed * m * n;
    partial += seed * gridDim.x * m;
    counter += seed;
    dot += seed * m;
    xsq += seed * m;
    nnz += seed * m;
    wbdot += seed * m;
    wsum += seed * n;
  }
  float* T = stage;
  float* X = stage + (size_t)RC * cols;
  const bool single = RC >= m;
  const float lam_t = scalar(lam_p, lam_v);
  auto prox = [&](float t) { return prox_l1 ? soft_threshold(t, lam_t) : t; };

  // pass 1: column sums of w, in a fixed order (S row segments per column
  // summed by S threads, then the segments in order)
  const int S = kSlabThreads / cols;
  float colsum = 0.f;
  for (int r0 = 0; r0 < m; r0 += RC) {
    const int rows = min(RC, m - r0);
    stage_rows<V>(T, theta, r0, rows, u0, W, units, n);
    cp_async_commit();
    if (single) {     // x lands while the column sums run
      stage_rows<V>(X, x, r0, rows, u0, W, units, n);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const int len = (rows + S - 1) / S;
    if (tid < S * cols) {
      const int c = tid % cols, k = tid / cols;
      const int r1 = min(rows, (k + 1) * len);
      float a = 0.f;
      for (int r = k * len; r < r1; ++r) a += prox(T[r * cols + c]);
      seg[k * cols + c] = a;
    }
    __syncthreads();
    if (tid < cols)
      for (int k = 0; k < S; ++k) colsum += seg[k * cols + tid];
    if (!single) __syncthreads();      // T is restaged
  }
  const bool col_ok = tid < cols && u0 + tid / V < units;
  if (single) cp_async_wait_all();
  if (tid < cols) wbar[tid] = col_ok ? colsum / m_real : 0.f;
  if (col_ok) wsum[(size_t)u0 * V + tid] = colsum;
  __syncthreads();

  // pass 2: per-node dot, xsq, nnz, wbdot of the slab's columns: P
  // neighbouring lanes per row (a power of two, P * rows <= 512), lane j
  // adding units j, j+P, ... in turn, then a butterfly over the P lanes
  for (int r0 = 0; r0 < m; r0 += RC) {
    const int rows = min(RC, m - r0);
    if (!single) {   // the slab did not fit: theta and x read again
      stage_rows<V>(T, theta, r0, rows, u0, W, units, n);
      stage_rows<V>(X, x, r0, rows, u0, W, units, n);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    int P = 1;
    while (P < 32 && 2 * P * rows <= kSlabThreads) P *= 2;
    for (int base = 0; base < rows * P; base += kSlabThreads) {
      const int t = base + tid, r = t / P, j = t % P;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);   // dot, xsq, nnz, wbdot
      if (r < rows)
        for (int u = j; u < W; u += P) {
          const Vec<V> tv = shared_vec<V>(T + r * cols + u * V);
          const Vec<V> xv = shared_vec<V>(X + r * cols + u * V);
          const Vec<V> wb = shared_vec<V>(wbar + u * V);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float w = prox(tv.v[v]), xe = xv.v[v];
            a.x += w * xe;
            a.y += xe * xe;
            a.z += w != 0.f ? 1.f : 0.f;
            a.w += wb.v[v] * xe;
          }
        }
      for (int off = P / 2; off > 0; off >>= 1) add4(a, shfl_xor4(a, off));
      if (r < rows && j == 0) partial[(size_t)tile * m + r0 + r] = a;
    }
    if (!single) __syncthreads();
  }

  // the last block of this seed to finish sums its blocks' partials: the
  // barrier orders the block's writes before thread 0's fence and ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  const int tiles = gridDim.x;
  const int G = m <= kSlabThreads ? kSlabThreads / m : 1;
  for (int base = 0; base < m * G; base += kSlabThreads) {
    const int t0 = base + tid, row = t0 % m, g = t0 / m;
    if (g >= G) continue;
    float sd = 0.f, ss = 0.f, sb = 0.f;
    int sz = 0;
    // tiles g, g+G, ... in ascending order, 16 loads in flight at a time
    for (int t1 = g; t1 < tiles; t1 += 16 * G) {
      float4 p[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int t = t1 + j * G;
        if (t < tiles) p[j] = __ldcg(partial + (size_t)t * m + row);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (t1 + j * G >= tiles) break;
        sd += p[j].x;
        ss += p[j].y;
        sz += (int)p[j].z;
        sb += p[j].w;
      }
    }
    if (G == 1) {
      dot[row] = sd;
      xsq[row] = ss;
      nnz[row] = sz;
      wbdot[row] = sb;
    } else {
      fin[g * m + row] = make_float4(sd, ss, __int_as_float(sz), sb);
    }
  }
  if (G > 1) {
    __syncthreads();
    if (tid < m) {
      float sd = 0.f, ss = 0.f, sb = 0.f;
      int sz = 0;
      for (int g = 0; g < G; ++g) {
        const float4 p = fin[g * m + tid];
        sd += p.x;
        ss += p.y;
        sz += __float_as_int(p.z);
        sb += p.w;
      }
      dot[tid] = sd;
      xsq[tid] = ss;
      nnz[tid] = sz;
      wbdot[tid] = sb;
    }
  }
  if (tid == 0) *counter = 0u;
}

// the OMD dual step mixed - alpha (coeff x), rounded after each operation
// as the torch ops of the reference backend round it (the clipped gradient
// coeff x, then alpha times it, then the difference): no contraction into
// a fused multiply-add, or the two backends part by an ulp each round
__device__ __forceinline__ float dual(float mixed, float cf, float xv,
                                      float alpha) {
  return __fsub_rn(mixed, __fmul_rn(alpha, __fmul_rn(cf, xv)));
}

// next = (A r)_i + diag_i (s - r) - alpha (coeff_i x), frozen rows keep
// theta; spelled with explicit fmaf so both mix paths round alike
__device__ __forceinline__ float finish(float acc, float th, float tl,
                                        float rv, float xv, float dg,
                                        float cf, float alpha, int noise_self,
                                        bool live) {
  const float s = noise_self ? tl : th;
  const float mixed = fmaf(dg, s - rv, acc);
  const float nxt = dual(mixed, cf, xv, alpha);
  return live ? nxt : th;
}

template <int V>
__global__ void __launch_bounds__(kSlabThreads)
update_sparse_kernel(const int* __restrict__ indptr,
                     const int* __restrict__ indices,
                     const float* __restrict__ weights, int nnz,
                     const float* __restrict__ theta,
                     const float* __restrict__ delta,
                     const float* __restrict__ x,
                     const float* __restrict__ recv,
                     const float* __restrict__ coeff,
                     const float* __restrict__ diag,
                     const float* __restrict__ alive,
                     const float* __restrict__ alpha_p, float alpha_v,
                     int use_recv, int noise_self, int m, int n, int units,
                     int W, float* __restrict__ out,
                     float* __restrict__ tilde_out) {
  // r of the whole slab: [m][W] units of V floats; the CSR form beside it
  // when it fits (else it is read from global memory)
  __shared__ __align__(16) float4 rbuf[kSlabUnits];
  __shared__ int s_ptr[kCsrRows + 1];
  __shared__ int s_idx[kCsrNnz];
  __shared__ float s_w[kCsrNnz];
  float* R = reinterpret_cast<float*>(rbuf);
  const int tid = threadIdx.x, u0 = blockIdx.x * W, slab = m * W;
  const float alpha = scalar(alpha_p, alpha_v);
  if (blockIdx.y) {  // seed > 0: its rows and per-node vectors
    const size_t seed = blockIdx.y, rows = seed * m * n;
    theta += rows;
    delta += rows;
    x += rows;
    recv += rows;
    out += rows;
    tilde_out += rows;
    coeff += seed * m;
    alive += seed * m;
  }

  Vec<V> th[kMaxE], tl[kMaxE], xv[kMaxE], rv[kMaxE];
  load_slab<V>(theta, 0, m, u0, W, units, n, th);
  load_slab<V>(delta, 0, m, u0, W, units, n, tl);
  load_slab<V>(x, 0, m, u0, W, units, n, xv);
  if (use_recv) load_slab<V>(recv, 0, m, u0, W, units, n, rv);
  // everything the mix needs after the barrier, loaded while those fly
  float cf[kMaxE], dg[kMaxE];
  bool live[kMaxE];
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    const int row = min((tid + e * kSlabThreads) / W, m - 1);
    cf[e] = __ldg(coeff + row);
    dg[e] = __ldg(diag + row);
    live[e] = __ldg(alive + row) > 0.f;
  }
  const bool staged = m <= kCsrRows && nnz <= kCsrNnz;
  if (staged) {
    for (int i = tid; i <= m; i += kSlabThreads) s_ptr[i] = __ldg(indptr + i);
    for (int i = tid; i < nnz; i += kSlabThreads) {
      s_idx[i] = __ldg(indices + i);
      s_w[i] = __ldg(weights + i);
    }
  }
  const int* ptr = staged ? s_ptr : indptr;
  const int* idx = staged ? s_idx : indices;
  const float* wts = staged ? s_w : weights;

#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    const int q = tid + e * kSlabThreads;
#pragma unroll
    for (int v = 0; v < V; ++v) tl[e].v[v] = th[e].v[v] + tl[e].v[v];
    if (!use_recv) rv[e] = tl[e];
    if (q < slab) {
      store_vec<V>(R + q * V, rv[e]);
      const int u = u0 + q % W;
      if (u < units)
        store_vec<V>(tilde_out + (size_t)(q / W) * n + (size_t)u * V, tl[e]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    const int q = tid + e * kSlabThreads;
    const int row = q / W, uq = q % W;
    if (q >= slab || u0 + uq >= units) continue;
    Vec<V> acc = zero_vec<V>();
    const int p1 = ptr[row + 1];
    for (int p = ptr[row]; p < p1; ++p) {
      const float a = wts[p];
      const Vec<V> rk = shared_vec<V>(R + (idx[p] * W + uq) * V);
#pragma unroll
      for (int v = 0; v < V; ++v) acc.v[v] = fmaf(a, rk.v[v], acc.v[v]);
    }
    Vec<V> o;
#pragma unroll
    for (int v = 0; v < V; ++v)
      o.v[v] = finish(acc.v[v], th[e].v[v], tl[e].v[v], rv[e].v[v],
                      xv[e].v[v], dg[e], cf[e], alpha, noise_self, live[e]);
    store_vec<V>(out + (size_t)row * n + (size_t)(u0 + uq) * V, o);
  }
}

template <int V>
__global__ void __launch_bounds__(kDThreads)
update_dense_kernel(const float* __restrict__ A,
                    const float* __restrict__ theta,
                    const float* __restrict__ delta,
                    const float* __restrict__ x,
                    const float* __restrict__ recv,
                    const float* __restrict__ coeff,
                    const float* __restrict__ diag,
                    const float* __restrict__ alive,
                    const float* __restrict__ alpha_p, float alpha_v,
                    int use_recv, int noise_self, int m, int n,
                    float* __restrict__ out, float* __restrict__ tilde_out) {
  // two stages of: A^T of the tile (As[k][row], rows padded so float4 reads
  // stay aligned), r (theta, or recv) and delta slices
  __shared__ __align__(16) float As[2][kDK][kDM + 4];
  __shared__ __align__(16) float Ps[2][kDK][kDN];
  __shared__ __align__(16) float Qs[2][kDK][kDN];
  const int tid = threadIdx.x;
  const float alpha = scalar(alpha_p, alpha_v);
  const int tx = tid & 7, ty = tid >> 3;                 // 8 x 16
  const int row0 = blockIdx.y * kDM, col0 = blockIdx.x * kDN;
  if (blockIdx.z) {  // seed > 0: its rows and per-node vectors
    const size_t seed = blockIdx.z, rows = seed * m * n;
    theta += rows;
    delta += rows;
    x += rows;
    recv += rows;
    out += rows;
    tilde_out += rows;
    coeff += seed * m;
    alive += seed * m;
  }
  const float* P = use_recv ? recv : theta;

  auto issue = [&](int st, int k0) {
    for (int e = tid; e < kDM * kDK; e += kDThreads) {
      const int r = e / kDK, k = e % kDK;
      const int gr = row0 + r, gk = k0 + k;
      const bool ok = gr < m && gk < m;
      cp_async4(&As[st][k][r], ok ? A + (size_t)gr * m + gk : A, ok);
    }
    for (int e = tid * V; e < kDK * kDN; e += kDThreads * V) {
      const int k = e / kDN, c = e % kDN;
      const int gk = k0 + k, gc = col0 + c;
      const bool ok = gk < m && gc < n;
      const size_t idx = ok ? (size_t)gk * n + gc : 0;
      if constexpr (V == 4) {
        cp_async16(&Ps[st][k][c], P + idx, ok);
        if (!use_recv) cp_async16(&Qs[st][k][c], delta + idx, ok);
      } else {
        cp_async4(&Ps[st][k][c], P + idx, ok);
        if (!use_recv) cp_async4(&Qs[st][k][c], delta + idx, ok);
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int steps = (m + kDK - 1) / kDK;
  issue(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < steps; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < steps) issue(st ^ 1, (kt + 1) * kDK);
    cp_async_commit();
    cp_async_wait_one();          // this thread's copies of step kt landed
    if (!use_recv)                // r = theta + delta, by the copying thread
      for (int e = tid * V; e < kDK * kDN; e += kDThreads * V)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int k = (e + v) / kDN, c = (e + v) % kDN;
          Ps[st][k][c] = Ps[st][k][c] + Qs[st][k][c];
        }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[st][k][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ps[st][k][tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();              // step kt's buffers are refilled next
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
    const float cf = coeff[r], dg = diag[r];
    const bool live = alive[r] > 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 8 * j;
      if (c >= n) continue;
      const size_t idx = (size_t)r * n + c;
      const float th = theta[idx];
      const float tl = th + delta[idx];
      const float rv = use_recv ? recv[idx] : tl;
      out[idx] = finish(acc[i][j], th, tl, rv, x[idx], dg, cf, alpha,
                        noise_self, live);
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
    const float nxt = dual(mixed[e], coeff[r], x[e], alpha);
    out[e] = alive[r] > 0.f ? nxt : theta[e];
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline int clamp_int(int64_t v, int64_t lo, int64_t hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

// round_stats' slab: W units per block (kStatsBlocks blocks where n allows),
// staged RC rows at a time in kStageBytes of shared memory
struct StatsSlab {
  int units, W, RC, blocks, smem;
};

inline StatsSlab stats_slab(int m, int n, int vec) {
  StatsSlab s;
  s.units = n / vec;
  s.W = clamp_int(cdiv(s.units, kStatsBlocks), 1, kMaxSlabCols / vec);
  const int row_bytes = 2 * s.W * vec * (int)sizeof(float);
  s.RC = clamp_int(kStageBytes / row_bytes, 1, m);
  s.blocks = (int)cdiv(s.units, s.W);
  s.smem = s.RC * row_bytes;
  return s;
}

template <int V>
int launch_stats(const float* theta, const float* x, const float* lam_p,
                 float lam_t, float m_real, int prox_l1, int seeds, int m, int n,
                 void* scratch, unsigned* counter, float* dot, float* xsq,
                 int* nnz, float* wbdot, float* wsum, cudaStream_t s) {
  const cudaError_t attr = cudaFuncSetAttribute(
      stats_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBytes);
  if (attr != cudaSuccess) return (int)attr;
  const StatsSlab sl = stats_slab(m, n, V);
  const dim3 grid((unsigned)sl.blocks, (unsigned)seeds);
  stats_kernel<V><<<grid, kSlabThreads, sl.smem, s>>>(
      theta, x, lam_p, lam_t, m_real, prox_l1, m, n, sl.units, sl.W, sl.RC,
      static_cast<float4*>(scratch), counter, dot, xsq, nnz, wbdot, wsum);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float4s of scratch round_stats needs per seed: (blocks, m) partials
int64_t rf_stats_scratch_float4s(int m, int n, int vec) {
  return (int64_t)stats_slab(m, n, vec).blocks * m;
}

// `seeds` runs stacked (see the header), one (S_max,) counter per seed
int rf_round_stats(const float* theta, const float* x, const float* lam_p,
                   float lam_t, float m_real, int prox_l1, int seeds, int m, int n,
                   int vec, void* scratch, unsigned* counter, float* dot,
                   float* xsq, int* nnz, float* wbdot, float* wsum,
                   void* stream) {
  if (seeds < 1 || seeds > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 4
             ? launch_stats<4>(theta, x, lam_p, lam_t, m_real, prox_l1, seeds,
                               m, n, scratch, counter, dot, xsq, nnz, wbdot,
                               wsum, s)
             : launch_stats<1>(theta, x, lam_p, lam_t, m_real, prox_l1, seeds,
                               m, n, scratch, counter, dot, xsq, nnz, wbdot,
                               wsum, s);
}

int rf_round_update_sparse(const int* indptr, const int* indices,
                           const float* weights, int nnz, const float* theta,
                           const float* delta, const float* x,
                           const float* recv, const float* coeff,
                           const float* diag, const float* alive,
                           const float* alpha_p, float alpha,
                           int use_recv, int noise_self, int seeds, int m,
                           int n, int vec, float* out, float* tilde,
                           void* stream) {
  // the slab holds all m rows (SPARSE_MAX_NODES in the wrapper)
  if (m > kSlabUnits || seeds < 1 || seeds > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int units = n / vec;
  const int W = clamp_int(cdiv(units, kSMs), 1, kSlabUnits / m);
  const dim3 blocks((unsigned)cdiv(units, W), (unsigned)seeds);
  if (vec == 4)
    update_sparse_kernel<4><<<blocks, kSlabThreads, 0, s>>>(
        indptr, indices, weights, nnz, theta, delta, x, recv, coeff, diag,
        alive, alpha_p, alpha, use_recv, noise_self, m, n, units, W, out,
        tilde);
  else
    update_sparse_kernel<1><<<blocks, kSlabThreads, 0, s>>>(
        indptr, indices, weights, nnz, theta, delta, x, recv, coeff, diag,
        alive, alpha_p, alpha, use_recv, noise_self, m, n, units, W, out,
        tilde);
  return (int)cudaGetLastError();
}

int rf_round_update(const float* A, const float* theta, const float* delta,
                    const float* x, const float* recv, const float* coeff,
                    const float* diag, const float* alive,
                    const float* alpha_p, float alpha,
                    int use_recv, int noise_self, int seeds, int m, int n,
                    int vec, float* out, float* tilde, void* stream) {
  if (seeds < 1 || seeds > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)cdiv(n, kDN), (unsigned)cdiv(m, kDM),
                  (unsigned)seeds);
  if (vec == 4)
    update_dense_kernel<4><<<grid, kDThreads, 0, s>>>(
        A, theta, delta, x, recv, coeff, diag, alive, alpha_p, alpha,
        use_recv, noise_self, m, n, out, tilde);
  else
    update_dense_kernel<1><<<grid, kDThreads, 0, s>>>(
        A, theta, delta, x, recv, coeff, diag, alive, alpha_p, alpha,
        use_recv, noise_self, m, n, out, tilde);
  return (int)cudaGetLastError();
}

int rf_dual_step(const float* mixed, const float* x, const float* theta,
                 const float* coeff, const float* alive, float alpha, int m,
                 int n, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = (int64_t)m * n;
  // enough blocks to fill 132 SMs several times over; the loop strides
  const int64_t blocks = cdiv(total, kThreads) < kSMs * 16
                             ? cdiv(total, kThreads) : kSMs * 16;
  dual_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(mixed, x, theta, coeff,
                                                    alive, alpha, m, n, out);
  return (int)cudaGetLastError();
}

const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
