// Hopper (sm_90a) kernels for the tied unembedding's three products: the
// logits and both gradients of logits = x . table^T.
//
// unembed_gemm — replaces no TPU kernel: the JAX reference leaves the tied
//   unembedding (src/repro/models/layers.py, unembed) to XLA. It replaces
//   the port's x.to(f32) @ table.to(f32).T and its autograd backward, three
//   full-f32 products that cuBLAS runs on the CUDA cores (TF32 stays off).
//   x (M, d) and table (V, d) are bfloat16; g, the logit gradient (M, V),
//   is float32:
//     logits (M, V) f32  = x . table^T           (unembed_logits_gemm)
//     dx     (M, d) bf16 = g . table             (unembed_grad_gemm<0>,
//                                                 then unembed_splitk_sum)
//     dtable (V, d) bf16 = g^T . x               (unembed_grad_gemm<1>)
//   No operand is rounded below what it holds. A bf16 x bf16 product is
//   exact in f32, so the logits are one bf16 tensor-core pass with f32
//   accumulators. g is split in registers into three bf16 terms,
//     hi = bf16(g), mid = bf16(g - hi), lo = bf16(g - hi - mid),
//   each residual exact in f32 and hi + mid + lo == g exactly (8 + 8 + 8
//   significant bits, the signs of round-to-nearest included) for every g
//   above 2^-110; the other operand is bf16 exactly, so lo.w + mid.w + hi.w
//   are three exact products summed in f32: an f32 product's result, summed
//   in another order. The gradients round to bf16 once, at the end, as the
//   backward of x.to(f32) and table.to(f32) rounds them today.
//   Bound: operations. At minicpm-2b's M 4,096, d 2,304, V 122,880 the
//   logits are 2.32 TFLOP of bf16 MMA and each gradient 3 x 2.32: 16.2
//   TFLOP, 16.4 ms at 989 TFLOP/s; the f32 work is 6.96 TFLOP. The bytes
//   (the f32 logits written once and g read once, 2.01 GB each; the bf16
//   table 0.57 GB a product) take ~2 ms at 3.35 TB/s.
//   Design: persistent blocks, one an SM, of three warpgroups: warpgroup 0
//   is the producer (one thread issues TMA loads into a ring of shared
//   memory stages, with full/empty mbarriers), warpgroups 1 and 2 each own
//   64 rows of the output tile and issue wgmma m64n128k16 with f32
//   accumulators (setmaxnreg moves the producer's registers to them). The
//   tensor cores' own sum over a chain of wgmmas rounds toward zero, which
//   at K = 2,304 costs ~10x the error of torch's f32 product; so each
//   k-block's product lands in a fresh accumulator (scale-d 0) that is
//   added to the tile's sums with an f32 add, round to nearest. The logits
//   take 128 x 256 tiles (two halves of 128 columns a k-block) and read
//   both operands K-major from 128-byte swizzled tiles (64 deep, 4
//   stages). The gradients take 128 x 128 tiles and read g as f32 (32 x 32
//   boxes, 128-byte swizzle, 64 deep, 4 stages), K-major for dx and
//   transposed (MN-major) for dtable; each consumer thread loads its A
//   fragment from shared memory, splits it, and issues three register-A
//   wgmmas, lo, then mid, then hi; the bf16 operand (table for dx, x for
//   dtable) is N-contiguous, read MN-major (tnspB). g is read from device
//   memory once a tile. dx has few tiles (M/128 x 18 at d = 2,304), so its
//   K = V is split in `splits` ranges, each writing an f32 partial;
//   unembed_splitk_sum adds them in split order and rounds to bf16: no
//   atomics, so a run repeats bit for bit. Tiles run M-fastest for the
//   logits (the table tile is shared by the M tiles in flight) and
//   N-fastest for the gradients (g's tile shared by the column tiles).
//   Rows beyond M (a decode batch of 1) come in as TMA's zero fill and are
//   never stored.
//
// Plain C interface: built with nvcc into a shared library and called
// through ctypes by src/repro_torch/kernels/unembed_gemm.py, which checks
// shapes, dtypes and alignment, allocates the outputs and the partials and
// passes PyTorch's current stream. Each entry point returns the CUDA error
// of its launches (0 = launched), or a negative code of its own
// (ug_error_string).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;        // producer warpgroup + 2 consumers
constexpr int kConsumers = 256;
constexpr int BM = 128, BN = 256;    // logits tile; 64 rows a consumer

// logits: bf16 x bf16, 64 deep
constexpr int kFwdBK = 64, kFwdStages = 4;
constexpr int kFwdA = BM * kFwdBK * 2;            // 16 KB
constexpr int kFwdB = BN * kFwdBK * 2;            // 32 KB

// gradients: 128 x 128 tiles, 64 deep; f32 g in 32 x 32 boxes (4 KB: four
// down the tile's 128 rows, two across its depth) and a bf16 operand in two
// 64-wide boxes (8 KB)
constexpr int kBwdBN = 128, kBwdBK = 64, kBwdStages = 4;
constexpr int kBox = 4096;                        // bytes of one g box
constexpr int kBBox = 64 * kBwdBK * 2;            // bytes of one B box
constexpr int kBwdA = 8 * kBox;                   // 32 KB
constexpr int kBwdB = 2 * kBBox;                  // 16 KB

constexpr size_t smem_bytes(int stages, int a, int b) {
  return 1024 + size_t(stages) * (a + b) + 2 * stages * sizeof(uint64_t);
}

constexpr int kEntryPointMissing = -1;
constexpr int kTensorMapFailed = -2;

__host__ __device__ constexpr int cdiv(long long a, int b) {
  return int((a + b - 1) / b);
}

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a wgmma operand in shared memory, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4)
         | uint64_t((lbo >> 4) & 0x3FFF) << 16
         | uint64_t((sbo >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define UG_ACC64_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

#define UG_ACC64_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
  "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63])

// d = A . B + (scale_d ? d : 0), A and B K-major in shared memory, N = 128
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      UG_ACC64_REGS ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : UG_ACC64_OPS(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d = A . B + (scale_d ? d : 0), A a bf16 fragment in registers, B MN-major
// in shared memory, N = 128
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      UG_ACC64_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : UG_ACC64_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> three bf16 pairs with hi + mid + lo == (a, b) exactly: each
// residual is exact in f32 (__fsub_rn, no contraction)
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = __fsub_rn(a, __low2float(h));
  const float rb = __fsub_rn(b, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(ra, __low2float(m)), __fsub_rn(rb, __high2float(m)));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// byte offset of f32 element (r, c) of a 32 x 32 box with 128-byte swizzle
__device__ __forceinline__ uint32_t box_off(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// -- the logits ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
unembed_logits_gemm(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_t,
                    float* __restrict__ out, int M, int V, int d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align1024(smem_raw);
  uint8_t* sb = sa + kFwdStages * kFwdA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kFwdStages * kFwdB);
  uint64_t* empty = full + kFwdStages;

  const int mt = cdiv(M, BM), tiles = mt * cdiv(V, BN), kb = cdiv(d, kFwdBK);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % mt) * BM, n0 = (t / mt) * BN;
        for (int k = 0; k < kb; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kFwdA + kFwdB);
          tma_load(sa + stage * kFwdA, &map_x, &full[stage], k * kFwdBK, m0);
          tma_load(sb + stage * kFwdB, &map_t, &full[stage], k * kFwdBK, n0);
          if (++stage == kFwdStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = wg - 1, tid = threadIdx.x % 128;
    const int row_in = 64 * w + 16 * (tid / 32) + (tid % 32) / 4;
    const int col_in = 2 * (tid % 4);
    // acc: the tile's f32 sums, columns 128 h + ... in acc[64 h ...]; each
    // k-block's product lands in part and is added to acc in f32 (the
    // tensor cores' own sum of a long chain rounds toward zero)
    float acc[128], part[64] = {};
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mt) * BM, n0 = (t / mt) * BN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int k = 0; k < kb; ++k) {
        mbar_wait(&full[stage], phase);
        const uint8_t* a = sa + stage * kFwdA + w * (64 * 128);
        const uint8_t* b = sb + stage * kFwdB;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          fence_acc(part);
          wg_fence();
#pragma unroll
          for (int s = 0; s < kFwdBK / 16; ++s)
            wgmma_ss(part, desc(a + 32 * s, 16, 1024),
                     desc(b + h * (128 * 128) + 32 * s, 16, 1024), s);
          wg_commit();
          wg_wait_all();
          fence_acc(part);
#pragma unroll
          for (int i = 0; i < 64; ++i)
            acc[64 * h + i] = __fadd_rn(acc[64 * h + i], part[i]);
        }
        mbar_arrive(&empty[stage]);
        if (++stage == kFwdStages) { stage = 0; phase ^= 1; }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + row_in + 8 * r;
        if (row < M) {
          float* dst = out + size_t(row) * V + n0 + col_in;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            // column 8 i + col_in: half i / 16, block i % 16 of it
            const int j = 64 * (i / 16) + 4 * (i % 16) + 2 * r;
            if (n0 + col_in + 8 * i < V)
              *reinterpret_cast<float2*>(dst + 8 * i) =
                  make_float2(acc[j], acc[j + 1]);
          }
        }
      }
    }
  }
}

// -- the gradients ------------------------------------------------------------
//
// MODE 0, dx: rows = M, k_total = V, A[m][v] = g[m][v] (K-major), B = table
//   (V, d); writes split `sp`'s f32 partial (rows, n) at out + sp*rows*n.
// MODE 1, dtable: rows = V, k_total = M, A[v][m] = g[m][v] (MN-major), B = x
//   (M, d); writes bf16 (rows, n). splits = 1.

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
unembed_grad_gemm(const __grid_constant__ CUtensorMap map_g,
                  const __grid_constant__ CUtensorMap map_b,
                  void* __restrict__ out, int rows, int n, int k_total,
                  int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align1024(smem_raw);
  uint8_t* sb = sa + kBwdStages * kBwdA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kBwdStages * kBwdB);
  uint64_t* empty = full + kBwdStages;

  const int mt = cdiv(rows, BM), nt = cdiv(n, kBwdBN);
  const int units = mt * nt * splits, kb_total = cdiv(k_total, kBwdBK);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int n0 = (u % nt) * kBwdBN, m0 = (u / nt % mt) * BM;
        const int sp = u / (nt * mt);
        const int k_lo = sp * kb_total / splits;
        const int k_hi = (sp + 1) * kb_total / splits;
        for (int k = k_lo; k < k_hi; ++k) {
          const int k0 = k * kBwdBK;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kBwdA + kBwdB);
          uint8_t* a = sa + stage * kBwdA;
          uint8_t* b = sb + stage * kBwdB;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              uint8_t* box = a + (4 * q + i) * kBox;
              if (MODE == 0)   // g rows m0 + 32i.., columns k0 + 32q..
                tma_load(box, &map_g, &full[stage], k0 + 32 * q, m0 + 32 * i);
              else             // g rows k0 + 32q.., columns m0 + 32i..
                tma_load(box, &map_g, &full[stage], m0 + 32 * i, k0 + 32 * q);
            }
          }
          tma_load(b, &map_b, &full[stage], n0, k0);
          tma_load(b + kBBox, &map_b, &full[stage], n0 + 64, k0);
          if (++stage == kBwdStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = wg - 1, tid = threadIdx.x % 128, lane = tid % 32;
    // this thread's A rows (64 w + 16 warp + lane/4, and + 8) and columns
    const int ar = 64 * w + 16 * (tid / 32) + lane / 4;
    const int ac = 2 * (lane % 4);
    // each k-block's three passes land in part, which is added to acc in
    // f32 (the tensor cores' own sum of a long chain rounds toward zero)
    float acc[64], part[64] = {};
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int n0 = (u % nt) * kBwdBN, m0 = (u / nt % mt) * BM;
      const int sp = u / (nt * mt);
      const int k_lo = sp * kb_total / splits;
      const int k_hi = (sp + 1) * kb_total / splits;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int k = k_lo; k < k_hi; ++k) {
        mbar_wait(&full[stage], phase);
        const uint8_t* a = sa + stage * kBwdA;
        const uint8_t* b = sb + stage * kBwdB;
        // step s's fragment (rows r, r + 8; depth 16 s + ac + 8 j, + 1) is
        // split and its three wgmmas issued while step s - 1's run
        uint32_t hi[kBwdBK / 16][4], mid[kBwdBK / 16][4], lo[kBwdBK / 16][4];
        fence_acc(part);
#pragma unroll
        for (int s = 0; s < kBwdBK / 16; ++s) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = ar + 8 * h, c = 16 * s + ac + 8 * j;
              // the box of A[r][c]: depth c / 32, rows r / 32
              const uint8_t* box = a + (4 * (c >> 5) + (r >> 5)) * kBox;
              float x0, x1;
              if (MODE == 0) {   // A[r][c], A[r][c+1]: row r%32, col c%32
                const float2 v = *reinterpret_cast<const float2*>(
                    box + box_off(r & 31, c & 31));
                x0 = v.x;
                x1 = v.y;
              } else {           // A[r][c] = g at row c%32, column r%32
                x0 = *reinterpret_cast<const float*>(
                    box + box_off(c & 31, r & 31));
                x1 = *reinterpret_cast<const float*>(
                    box + box_off((c & 31) + 1, r & 31));
              }
              split3(x0, x1, hi[s][2 * j + h], mid[s][2 * j + h],
                     lo[s][2 * j + h]);
            }
          }
          wg_fence();
          const uint64_t db = desc(b + 2048 * s, kBBox, 1024);
          wgmma_rs(part, lo[s], db, s);
          wgmma_rs(part, mid[s], db, 1);
          wgmma_rs(part, hi[s], db, 1);
        }
        wg_commit();
        wg_wait_all();
        fence_acc(part);
        mbar_arrive(&empty[stage]);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        if (++stage == kBwdStages) { stage = 0; phase ^= 1; }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + ar + 8 * h;
        if (row >= rows) continue;
#pragma unroll
        for (int i = 0; i < kBwdBN / 8; ++i) {
          const int col = n0 + ac + 8 * i;
          if (col >= n) continue;
          const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
          if (MODE == 0) {
            float* dst = static_cast<float*>(out) + size_t(sp) * rows * n;
            *reinterpret_cast<float2*>(dst + size_t(row) * n + col) =
                make_float2(v0, v1);
          } else {
            __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out);
            *reinterpret_cast<__nv_bfloat162*>(dst + size_t(row) * n + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// dx = bf16(sum over s of part[s]), in split order; count % 4 == 0
__global__ void unembed_splitk_sum(const float4* __restrict__ part,
                                   __nv_bfloat162* __restrict__ out,
                                   long long count4, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < count4; i += (long long)gridDim.x * blockDim.x) {
    float4 acc = __ldcs(part + i);
    for (int s = 1; s < splits; ++s) {
      const float4 v = __ldcs(part + s * count4 + i);
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    out[2 * i] = __floats2bfloat162_rn(acc.x, acc.y);
    out[2 * i + 1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// -- host side -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess && p)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (outer, inner) tensor read in (box_outer, box_inner) boxes
// with 128-byte swizzle; rows past the end come in as zeros
int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
             const void* ptr, long long outer, long long inner,
             int box_inner, int box_outer) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return kEntryPointMissing;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t strides[1] = {cuuint64_t(inner) * elem_bytes};
  const cuuint32_t box[2] = {cuuint32_t(box_inner), cuuint32_t(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapFailed;
}

// let `kernel` take `smem` bytes of dynamic shared memory
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

}  // namespace

extern "C" {

// logits (M, V) f32 = x (M, d) bf16 . table (V, d) bf16 ^T
int ug_logits(const void* x, const void* table, float* out, int M, int V,
              int d, int sms, void* stream) {
  CUtensorMap mx, mt;
  int code = make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, d,
                      kFwdBK, BM);
  if (!code) code = make_map(&mt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, table,
                             V, d, kFwdBK, BN);
  const size_t smem = smem_bytes(kFwdStages, kFwdA, kFwdB);
  if (!code) code = allow_smem(unembed_logits_gemm, smem);
  if (code) return code;
  const int tiles = cdiv(M, BM) * cdiv(V, BN);
  unembed_logits_gemm<<<tiles < sms ? tiles : sms, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(mx, mt, out, M,
                                                             V, d);
  return (int)cudaGetLastError();
}

// dx (M, d) bf16 = g (M, V) f32 . table (V, d) bf16, through `splits` f32
// partials (splits, M, d)
int ug_grad_x(const float* g, const void* table, float* partial, void* dx,
              int M, int V, int d, int splits, int sms, void* stream) {
  CUtensorMap mg, mb;
  int code = make_map(&mg, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g, M, V, 32,
                      32);
  if (!code) code = make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, table,
                             V, d, 64, kBwdBK);
  const size_t smem = smem_bytes(kBwdStages, kBwdA, kBwdB);
  if (!code) code = allow_smem(unembed_grad_gemm<0>, smem);
  if (code) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int units = cdiv(M, BM) * cdiv(d, kBwdBN) * splits;
  unembed_grad_gemm<0><<<units < sms ? units : sms, kThreads, smem, st>>>(
      mg, mb, partial, M, d, V, splits);
  code = (int)cudaGetLastError();
  if (code) return code;
  const long long count4 = (long long)M * d / 4;
  const long long want = (count4 + 255) / 256;
  const int blocks = int(want < 8LL * sms ? want : 8LL * sms);
  unembed_splitk_sum<<<blocks, 256, 0, st>>>(
      reinterpret_cast<const float4*>(partial),
      static_cast<__nv_bfloat162*>(dx), count4, splits);
  return (int)cudaGetLastError();
}

// dtable (V, d) bf16 = g (M, V) f32 ^T . x (M, d) bf16
int ug_grad_table(const float* g, const void* x, void* dtable, int M, int V,
                  int d, int sms, void* stream) {
  CUtensorMap mg, mb;
  int code = make_map(&mg, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g, M, V, 32,
                      32);
  if (!code) code = make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M,
                             d, 64, kBwdBK);
  const size_t smem = smem_bytes(kBwdStages, kBwdA, kBwdB);
  if (!code) code = allow_smem(unembed_grad_gemm<1>, smem);
  if (code) return code;
  const int units = cdiv(V, BM) * cdiv(d, kBwdBN);
  unembed_grad_gemm<1><<<units < sms ? units : sms, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      mg, mb, dtable, V, d, M, 1);
  return (int)cudaGetLastError();
}

const char* ug_error_string(int code) {
  if (code == kEntryPointMissing)
    return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == kTensorMapFailed)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
