// The input projection of the LSTM blocks of ResLSTM / ResBiLSTM for Hopper
// (sm_90a): xp[t, b, :] = x[b, t, :] W_x + bias, f32-accurate on the tensor
// cores, written time-major for the recurrence (csrc/lstm.cu).
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA
// inside its `nn.scan` (deepxi_tpu/models/rnn.py:45), and the port hoisted it
// out of the recurrence as one matrix product a block (models/rnn.py). There
// it was an f32 cuBLAS GEMM on FMAs and a copy of its transposed view into
// the time-major layout the recurrence reads: at reslstm-1.0c's offline
// batch, [60,096, 512] x [512, 2048] a block, 126 GFLOP at 67 TFLOP/s and
// 492 MB written twice.
//
// What bounds it on this card: operations. Each f32 product is three TF32
// products on the tensor cores (csrc/mma_tf32x3.cuh: a_lo b_hi + a_hi b_lo +
// a_hi b_hi, small terms first), 165 TFLOP/s of f32-accurate work against
// x, W_x and xp once at 3.35 TB/s (0.76 ms against 0.18 ms a block).
//
// Design:
//   * `lstm_input_proj_split_kernel` writes the four gate kernels W_g [K, H]
//     side by side as W_x [K, N = 4H], K-major and split into their TF32 hi
//     and lo parts: w_split [2][N][K] (8 MB at K = 512, N = 2048), the B
//     operand as wgmma reads it. The caller keeps it while the weights stay
//     as they are (ops/kernels/lstm.py), so a call with unchanged weights
//     launches the product alone.
//   * `lstm_input_proj_kernel<BN>`: a persistent grid (at most a CTA an SM)
//     walks 128 x BN tiles of xp, row tiles outer, so the CTAs in flight share
//     their rows of x in L2. A producer warp keeps a ring of STAGES k-tiles
//     (32 floats deep: x's 128 rows, W's hi and lo BN rows, by TMA with
//     128-byte swizzle) ahead of two consumer warpgroups, each of which owns
//     64 rows of the tile. A consumer reads its x fragments from shared
//     memory (conflict-free under the swizzle), splits them in registers and
//     issues `wgmma` m64nBNk8 with A from registers and B (W's hi or lo) from
//     shared memory: three products a k-step, 12 a k-tile, into a fresh
//     accumulator that is added to the running sum in f32 after each k-tile
//     (the tensor cores' own accumulation does not round to nearest:
//     csrc/mma_tf32x3.cuh). While one warpgroup drains and adds, the other's
//     products keep the tensor cores busy.
//   * The epilogue adds the bias and stores each row of x's [B, T] order at
//     its time-major row t B + b, as 8-byte streaming stores.
//   * BN = 128, or 64 where 128-wide tiles would leave SMs idle (a few
//     hundred rows, as B = 1 x 250 frames).
//   * float64 takes `lstm_input_proj_f64_kernel`: 64 x 64 tiles on FMAs,
//     the bias and the time-major store in its epilogue, any K.
// In float32 K takes any multiple of 4 (TMA's 16-byte row pitch), the tails
// of M, N and K zero-filled by TMA and masked at the store. On an H100 SXM
// (700 W) a block of the offline batch takes 1.13 ms, 111.7 TFLOP/s, 68% of
// the bound; cuBLAS's addmm and the copy took 2.94 ms (PERF.md, row 14).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "deepxi_error.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int BM = 128;        // rows of x a tile: two warpgroups of 64
constexpr int BK = 32;         // a k-tile: 32 floats, one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int SPLIT_TILE = 32;
constexpr int F64_TILE = 64;  // the float64 kernel's tile: 256 threads, 4 x 4 each
constexpr int F64_BK = 16;

// The four gate kernels W_i, W_f, W_g, W_o [K, H], packed rows; W_x [K, 4H]
// is them side by side.
template <typename T>
struct Gates {
  const T* w[4];
};

template <int BN>
struct Plan {
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int REGS = BN / 2;  // accumulator floats a thread
  // the ring, 1024-byte aligned for the swizzle, and its barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma descriptor of a K-major tile in shared memory as TMA's 128-byte
// swizzle lays it out: rows of 128 bytes, 8-row groups 1024 bytes apart.
// A k-step of 8 floats further is 32 bytes on the start address.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins a register's value at this point for the compiler, so that no write
// of it moves past a wgmma fence or read of it ahead of a wait.
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (+)= a b for a 64 x 8 A in registers (TF32; warp w of the warpgroup
// holds rows 16 w .. 16 w + 15 as mma.sync's m16n8k8 A fragment) and an
// 8 x BN B at `desc_b`; SCALE_D 0 writes d, 1 adds to it.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(SCALE_D));
}

template <int SCALE_D>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(SCALE_D));
}

template <int BN, int SCALE_D>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], const uint32_t (&a)[4],
                                      uint64_t desc_b) {
  if constexpr (BN == 128)
    wgmma_n128<SCALE_D>(d, a, desc_b);
  else
    wgmma_n64<SCALE_D>(d, a, desc_b);
}

// w_split[0][n][k] = tf32 hi of W_x[k][n], w_split[1][n][k] its lo (the
// bits of mma_tf32x3.cuh's `split_tf32`).
__global__ void lstm_input_proj_split_kernel(Gates<float> w, uint32_t* __restrict__ w_split,
                                             int K, int H) {
  __shared__ float tile[SPLIT_TILE][SPLIT_TILE + 1];
  const int N = 4 * H, n0 = blockIdx.x * SPLIT_TILE, k0 = blockIdx.y * SPLIT_TILE;
  for (int i = threadIdx.y; i < SPLIT_TILE; i += blockDim.y) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    tile[i][threadIdx.x] = k < K && n < N ? w.w[n / H][(size_t)k * H + n % H] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < SPLIT_TILE; i += blockDim.y) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < N && k < K) {
      uint32_t hi, lo;
      split_tf32(tile[threadIdx.x][i], hi, lo);
      w_split[(size_t)n * K + k] = hi;
      w_split[(size_t)N * K + (size_t)n * K + k] = lo;
    }
  }
}

// The float64 product: a 64 x 64 tile of xp a CTA, each thread 4 x 4 of it
// (rows ty + 16 i, columns tx + 16 j), k in steps of 16 through shared
// memory, summed in order by FMAs; the bias and the time-major store as in
// the float32 kernel.
__global__ void __launch_bounds__(256)
    lstm_input_proj_f64_kernel(const double* __restrict__ x, Gates<double> w,
                               const double* __restrict__ bias, double* __restrict__ xp, int M,
                               int K, int H, int B, int T) {
  __shared__ double xs[F64_BK][F64_TILE + 1];
  __shared__ double ws[F64_BK][F64_TILE];
  const int N = 4 * H, m0 = blockIdx.y * F64_TILE, n0 = blockIdx.x * F64_TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  double acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += F64_BK) {
    for (int l = threadIdx.x; l < F64_TILE * F64_BK; l += 256) {
      const int mm = l / F64_BK, kk = l % F64_BK, m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = m < M && k < K ? x[(size_t)m * K + k] : 0.0;
      const int kw = l / F64_TILE, nn = l % F64_TILE, n = n0 + nn;
      ws[kw][nn] = n < N && k0 + kw < K ? w.w[n / H][(size_t)(k0 + kw) * H + n % H] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F64_BK; ++kk) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][ty + 16 * i];
        b[i] = ws[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    double* y = xp + ((size_t)(m % T) * B + m / T) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[n] = acc[i][j] + bias[n];
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_input_proj_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           const float* __restrict__ bias, float* __restrict__ xp, int M,
                           int N, int K, int B, int T) {
  using P = Plan<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(ring + STAGES * P::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int KT = (K + BK - 1) / BK;

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES, use = it / STAGES;
          if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
          unsigned char* stage = ring + s * P::STAGE_BYTES;
          mbar_expect_tx(&full[s], P::STAGE_BYTES);
          tma_load_2d(stage, &map_x, &full[s], kt * BK, m0);
          tma_load_3d(stage + P::A_BYTES, &map_w, &full[s], kt * BK, n0, 0);
          tma_load_3d(stage + P::A_BYTES + P::B_BYTES, &map_w, &full[s], kt * BK, n0, 1);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile; this
  // thread's A rows are r and r + 8 (the same row in the swizzle's 8-row
  // period), its accumulator rows the same
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r = 64 * wg + 16 * (warp % 4) + g;
  const int a_off = r * 128 + t * 4;
  float acc[P::REGS], part[P::REGS];
#pragma unroll
  for (int i = 0; i < P::REGS; ++i) part[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
#pragma unroll
    for (int i = 0; i < P::REGS; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* stage = ring + s * P::STAGE_BYTES;
      FragA a[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned char* p0 = stage + a_off + (((2 * kk) ^ g) << 4);
        const unsigned char* p1 = stage + a_off + (((2 * kk + 1) ^ g) << 4);
        set_a(a[kk], *(const float*)p0, *(const float*)(p0 + 1024), *(const float*)p1,
              *(const float*)(p1 + 1024));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pin(a[kk].hi[i]);
          pin(a[kk].lo[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < P::REGS; ++i) pin(part[i]);
      const uint64_t d_hi = desc_sw128(stage + P::A_BYTES);
      const uint64_t d_lo = desc_sw128(stage + P::A_BYTES + P::B_BYTES);
      wgmma_fence();
      // small terms first, as mma_tf32x3 sums them
      wgmma<BN, 0>(part, a[0].lo, d_hi);
      wgmma<BN, 1>(part, a[0].hi, d_lo);
      wgmma<BN, 1>(part, a[0].hi, d_hi);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) {
        wgmma<BN, 1>(part, a[kk].lo, d_hi + 2 * kk);
        wgmma<BN, 1>(part, a[kk].hi, d_lo + 2 * kk);
        wgmma<BN, 1>(part, a[kk].hi, d_hi + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < P::REGS; ++i) pin(part[i]);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < P::REGS; ++i) acc[i] += part[i];
    }
    // epilogue: bias, then rows m0 + r and m0 + r + 8 at their time-major rows
    const int ma = m0 + r, mb = ma + 8;
    float* ya = xp + ((size_t)(ma % T) * B + ma / T) * N;
    float* yb = xp + ((size_t)(mb % T) * B + mb / T) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < N) {  // N is a multiple of 4, so col + 1 < N too
        const float b0 = bias[col], b1 = bias[col + 1];
        if (ma < M)
          __stcs((float2*)(ya + col), make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1));
        if (mb < M)
          __stcs((float2*)(yb + col), make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1));
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up once through the runtime (nothing
// links against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    cudaGetLastError();
    fn = (EncodeTiled)p;
  }
  return fn;
}

// A map of an f32 tensor of `rank` dims (innermost first, innermost packed)
// read in boxes of `box` with 128-byte swizzle, zeros past its edges.
int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
           const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ENCODER_MISSING;
  cuuint64_t strides[2] = {dims[0] * 4, rank > 2 ? dims[0] * dims[1] * 4 : 0};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims, strides,
         box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_FAILED;
}

template <int BN>
int launch(const void* x, const void* w_split, const void* bias, void* xp, int B, int T, int K,
           int N, int ctas, int dev, cudaStream_t st) {
  using P = Plan<BN>;
  const int M = B * T;
  CUtensorMap map_x, map_w;
  const cuuint64_t dims_x[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint32_t box_x[2] = {BK, BM};
  const cuuint64_t dims_w[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};
  const cuuint32_t box_w[3] = {BK, BN, 1};
  int rc = encode(&map_x, x, 2, dims_x, box_x);
  if (rc == 0) rc = encode(&map_w, w_split, 3, dims_w, box_w);
  if (rc != 0) return rc;
  static bool sized[64] = {};  // the shared-memory limit, raised once a device
  if (!sized[dev & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_input_proj_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized[dev & 63] = true;
  }
  lstm_input_proj_kernel<BN><<<ctas, THREADS, P::SMEM, st>>>(map_x, map_w, (const float*)bias,
                                                              (float*)xp, M, N, K, B, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w_split [2][4H][K] (int32 bits, 16-byte aligned) = the gate kernels w_i,
// w_f, w_g, w_o [K, H] (float32) side by side, K-major, in TF32 hi and lo:
// one launch on `stream`; returns 0 or the error.
int lstm_input_proj_split(const void* w_i, const void* w_f, const void* w_g, const void* w_o,
                          void* w_split, int K, int H, void* stream) {
  if (K < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Gates<float> w{{(const float*)w_i, (const float*)w_f, (const float*)w_g,
                        (const float*)w_o}};
  lstm_input_proj_split_kernel<<<dim3((4 * H + SPLIT_TILE - 1) / SPLIT_TILE,
                                      (K + SPLIT_TILE - 1) / SPLIT_TILE),
                                 dim3(SPLIT_TILE, 8), 0, (cudaStream_t)stream>>>(
      w, (uint32_t*)w_split, K, H);
  return (int)cudaGetLastError();
}

// xp [T, B, N] (time-major) = x [B, T, K] (rows b T + t, packed) times W_x
// [K, N], given as `lstm_input_proj_split` wrote it, plus bias [N], all
// float32 and 16-byte aligned, K and N multiples of 4. One launch on
// `stream`; returns 0 or the error (cudaErrorInvalidValue where the shapes
// do not fit).
int lstm_input_proj_forward(const void* x, const void* w_split, const void* bias, void* xp,
                            int B, int T, int K, int N, void* stream) {
  if (B < 1 || T < 1 || K < 4 || N < 4 || K % 4 || N % 4 ||
      ((uintptr_t)x | (uintptr_t)w_split) % 16)
    return (int)cudaErrorInvalidValue;
  int dev;
  cudaGetDevice(&dev);
  static int sms_of[64] = {};  // SMs a device, read once
  int& sms = sms_of[dev & 63];
  if (sms == 0) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // 128 columns a tile, or 64 where 128-wide tiles would be fewer than the SMs
  const int M = B * T, bn = (long)((M + BM - 1) / BM) * ((N + 127) / 128) >= sms ? 128 : 64;
  const long tiles = (long)((M + BM - 1) / BM) * ((N + bn - 1) / bn);
  const int ctas = (int)(tiles < sms ? tiles : sms);
  cudaStream_t st = (cudaStream_t)stream;
  return bn == 128 ? launch<128>(x, w_split, bias, xp, B, T, K, N, ctas, dev, st)
                   : launch<64>(x, w_split, bias, xp, B, T, K, N, ctas, dev, st);
}

// The same product in float64 from the gate kernels w_i, w_f, w_g, w_o [K,
// H] directly (N = 4H), on FMAs: one launch on `stream`; returns 0 or the
// error.
int lstm_input_proj_f64(const void* x, const void* w_i, const void* w_f, const void* w_g,
                        const void* w_o, const void* bias, void* xp, int B, int T, int K, int H,
                        void* stream) {
  if (B < 1 || T < 1 || K < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Gates<double> w{{(const double*)w_i, (const double*)w_f, (const double*)w_g,
                         (const double*)w_o}};
  const int M = B * T;
  lstm_input_proj_f64_kernel<<<dim3((4 * H + F64_TILE - 1) / F64_TILE,
                                    (M + F64_TILE - 1) / F64_TILE),
                               256, 0, (cudaStream_t)stream>>>(
      (const double*)x, w, (const double*)bias, (double*)xp, M, K, H, B, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
