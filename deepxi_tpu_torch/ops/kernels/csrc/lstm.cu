// The masked LSTM recurrence of ResLSTM / ResBiLSTM for Hopper (sm_90a):
// its forward and its backward, each one persistent launch a call.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as flax's
// `nn.scan` over `nn.OptimizedLSTMCell` (deepxi_tpu/models/rnn.py:45), which
// XLA compiles into one while-loop, and differentiates that loop by XLA's
// autodiff. The port needs the forward as one op, so that an exported
// program holds one call a direction a block, and the backward as a kernel,
// so that training runs the recurrence on the card (ops/kernels/lstm.py).
//
// Forward. Per frame t, in processing order (t = 0 .. T-1, or T-1 .. 0 with
// `reverse`), for every batch row b and hidden unit j:
//   z[g] = xp[t, b, g H + j] + sum_k h[b, k] w_h[k, g H + j]   (gates i|f|g|o)
//   c'   = sigmoid(z_f) c + sigmoid(z_i) tanh(z_g)
//   h'   = sigmoid(z_o) tanh(c')
// where the frame's mask is set; where it is not, (c, h) stay as they were.
// ys[t, b, j] is h after the frame. The carry starts at zero. xp already
// holds the input product and the recurrent bias (one matrix product over
// all frames, outside this kernel). The training forward also writes the
// gate activations (i, f, g, o) [T, B, 4H] and c after each frame [T, B, H].
//
// Backward. Per frame in the reverse of processing order, with the carry
// (dh, dc) starting at zero and dy = dys[t]: where the frame is valid,
//   dh_tot = dh + dy,  dz_o = dh_tot tanh(c_t) o (1 - o),
//   dc_tot = dc + dh_tot o (1 - tanh^2 c_t),
//   dz_i = dc_tot g i (1 - i),  dz_g = dc_tot i (1 - g^2),
//   dz_f = dc_tot c_{t-1} f (1 - f),  dc <- dc_tot f,  dh <- dz_t w_h^T;
// where it is masked, dz_t = 0, dh <- dh + dy and dc stays. dxp = dz.
// (dW_h = sum_t h_{t-1}^T dz_t is one matrix product after the kernel.)
//
// What bounds it on this card: operations. The recurrent product is
// 8 B H^2 FLOP a frame in either direction, against bytes of xp, ys and w_h
// once; at reslstm-1.0c's H = 512 and B = 32 the FLOPs take 1 us a frame at
// the f32 peak (0.4 us at the 165 TFLOP/s of three TF32 tensor-core
// products; mma.sync m16n8k8 TF32 measured 320 TFLOP/s on this card, 6
// cycles an instruction a sub-partition, 25 cycles dependent: 0.6 us), and at
// B <= 8 a frame is a few us of latency: barriers and L2 round trips. Both
// kernels are one cooperative launch a call (cudaLaunchCooperativeKernel: the
// launch is refused, never hung, when its grid cannot be resident at once),
// at most one CTA an SM, and keep what does not have to cross CTAs on chip.
//
// Forward (`lstm_forward_kernel`; `lstm_forward_kernel_tc` on the tensor
// cores):
//   * The grid is ceil(H / U) x R CTAs: CTA (x, y) owns hidden units
//     [x U, x U + U) of row group y (ceil(B / R) batch rows) for all T
//     frames, so the cell state of its units stays in shared memory, and its
//     slice of w_h, the 4U columns [H, 4U] (128 KiB in f32 at H = 512, U =
//     16), is loaded into shared memory once. Where no slice fits (float64 at
//     large H) the same kernel reads it from L2 (template flag WS = false).
//     More row groups (R up to 4, with U as large as the SMs then need) mean
//     each CTA stages fewer rows a frame.
//   * Each frame ends at one grid-wide barrier (cooperative_groups'
//     grid.sync(), ~1.1 us on this card, which orders the frame's global
//     writes before every CTA's reads after it): every CTA stages h_{t-1} of
//     its rows (= ys of the previous frame, written by the row group's CTAs)
//     into shared memory (the FMA route NB rows at a time as [H][NB]),
//     computes its 4U columns of the product, applies the cell to its units
//     and writes ys[t].
//     Each thread's share of the cell (its xp and mask) is loaded in one go
//     ahead of the arithmetic.
//   * The product, f32-accurate, by one of two routes, chosen by the rows a
//     CTA in the call's shape (`stage_plan`):
//   * FMAs (float64, and float32 below LSTM_FWD_TC_ROWS = 6 rows a CTA):
//     512 threads (16 warps) blocked in registers: a thread sums four
//     columns of NB rows (each h value feeds four FMAs, each w_h value NB);
//     operands are read as 16-byte vectors. A thread takes an interleaved
//     share of the reduction; the lanes of a warp that share columns fold by
//     shuffles, the 16 warps' sums meet in shared memory ([WARPS][NB][4U])
//     and are added in warp order. That buffer beside the slice holds NB = 8
//     rows at H = 512, so 24 rows a CTA take three serial stages a frame.
//   * Tensor cores (`lstm_forward_kernel_tc`, float32 from 6 rows a CTA, U
//     >= 4, H % 4 == 0, up to 32 rows a CTA: more take the FMA route): all
//     of the CTA's rows in one stage a frame, mma.sync m16n8k8 TF32 with
//     both operands split as csrc/mma_tf32x3.cuh splits (three products, small terms
//     first; 8 k-steps summed in a fragment, then in f32). M = the CTA's 4U
//     columns, N = its rows, K = H in S = 64 / U parts: warp w takes m-block
//     w % (U / 4) of part w / (U / 4) for every n-block, and the cell adds
//     the S parts in order. Shared memory at H = 512, U = 16, 24 rows (the
//     232,448 bytes a CTA may have, exactly): w_h's slice as A fragments in
//     fragment order, [4][64][32] x 16 bytes (a lane's four values one
//     16-byte word, no bank conflict), written once a launch; h_{t-1} of the
//     rows [24][1040], each value split once a frame as it is staged and
//     stored as pairs (hi, hi, lo, lo) so that a lane's B fragment is one
//     16-byte word (a fragment's k column t is read as k = 2t and t + 4 as
//     2t + 1); the parts' sums [4][24][68] over the staged rows once the
//     product is done; the cell state. The n-block count is a template
//     argument and the warp index is broadcast by a shuffle, so that no
//     mma.sync sits under a branch the compiler cannot see is warp-uniform
//     (under one it wraps every mma.sync in a WARPSYNC, and the product took
//     twice as long). The threshold is measured (tools/torch_lstm_phases.py
//     forces each route; PERF.md, row 12): at H = 512 FMAs are ahead at 1,
//     2 and 4 rows a CTA, the tensor cores from 6 (by 7% at 6, 1.8x at 24).
//   * h_{t-1}, written during the launch, is read through L2
//     (ld.global.cg, never a stale L1 line); xp and w_h are read-only.
//
// Backward (`lstm_backward_kernel`), a reduce-scatter over the row group:
//   * The same grid shape (its own plan, `grid_plan(backward)`): CTA (x, y)
//     owns units [x U, x U + U) of row group y, keeps the carry (dh, dc) of
//     its units in shared memory, and holds the forward's slice of w_h, its
//     4U columns [H, 4U], in registers for the FMA route (f32; a thread one
//     or two rows of it over the 4U columns, 64 values at most; float64
//     reads them from L2) and in shared memory for the tensor cores.
//   * A frame: the cell's backward for the CTA's units (its inputs, the saved
//     gates, c_t, c_{t-1}, dy and the mask, were copied into shared memory by
//     cp.async while the CTA waited at the previous barrier) writes dz_t's 4U
//     columns to dxp and to shared memory; then the CTA multiplies them by
//     its slice, dz_t[:, cols] w_h[:, cols]^T, a partial dh [rows, H] for
//     every unit, and writes it to scratch in global memory without waiting
//     on any other CTA, laid out by the CTA that will read it. After the row
//     group's barrier each CTA sums the group's NX partials of its own units,
//     one contiguous block (ld.global.cg), lanes of an element summing CTAs
//     in order and folding by a butterfly. A frame moves 2 rows H values a
//     CTA through L2, where staging the whole dz_t of the rows (rows 4H) did.
//     An element's prefetch, cell, carry and sum are one thread's, so the
//     frame has three CTA barriers and none around the cell's inputs.
//   * The product, f32-accurate, by one of two routes. From LSTM_TC_ROWS
//     rows a CTA on the tensor cores: mma.sync m16n8k8 TF32 with split
//     operands (csrc/mma_tf32x3.cuh; M = 16 units of dh, N = 8 batch rows,
//     K = 8 of the CTA's columns), the A fragments in shared memory in
//     fragment order (a lane's four values one 16-byte word, no bank
//     conflict), split each frame in two instructions, hi the bits with the
//     low 13 cleared and lo = w - hi exactly, which the tensor cores read as
//     TF32 by their top 19 bits; dz_t split as the header splits. Below
//     that, where the tensor cores' fixed 8-row N and the split of w_h each
//     frame cost more, and in float64, on FMAs: each thread's rows of w_h,
//     held in registers, against each row of dz_t, read as broadcast 16-byte
//     words.
//   * The barrier is the row group's own: its NX CTAs meet on an arrival
//     counter in the call's scratch (red.release.gpu once the partials are
//     written, ld.relaxed.gpu polls and fence.acq_rel.gpu before they are
//     read); the partials are double-buffered by frame parity, so a CTA a
//     frame ahead never writes what a slower one still reads. The counters
//     are zeroed in the launch behind one grid.sync(). The cooperative
//     launch's co-residency is what makes the spin safe; the scratch comes
//     from the caller each call (PyTorch's caching allocator on the call's
//     stream), so calls on several streams never share a counter.
//   * Fixed orders and no atomics in any sum: a second call is bitwise equal.
// Domain: float32 or float64, 1 <= H <= 1024, B >= 1, T >= 1, U in {1, 2, 4,
// 8, 16}, 1 <= R <= B; B is bounded by the shared memory the per-unit state of
// a row group takes. The caller checks the domain (kernel_takes) and raises
// outside it; a plan that does not fit returns cudaErrorInvalidValue, a grid
// that cannot be resident cudaErrorCooperativeLaunchTooLarge.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "deepxi_error.cuh"
#include "mma_tf32x3.cuh"

namespace cg = cooperative_groups;

// Phase times for tools/torch_lstm_phases.py, built only with -DLSTM_PHASES=1:
// thread 0 of CTA (0, 0) adds the %globaltimer ns each phase of each frame
// takes (the forward's into g_phase_ns[0..4], the backward's into [8..15]).
#if LSTM_PHASES
__device__ unsigned long long g_phase_ns[16];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASES_BEGIN unsigned long long phase_ns[8] = {0, 0, 0, 0, 0, 0, 0, 0}, phase_t0 = now_ns();
#define PHASE(i)                                                              \
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {               \
    const unsigned long long t1 = now_ns();                                   \
    phase_ns[i] += t1 - phase_t0;                                             \
    phase_t0 = t1;                                                            \
  }
#define PHASES_END(at)                                                        \
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)                 \
    for (int i = 0; i < 8; ++i) g_phase_ns[(at) + i] = phase_ns[i];
#else
#define PHASES_BEGIN
#define PHASE(i)
#define PHASES_END(at)
#endif

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_H = 1024;
constexpr size_t MAX_SMEM = 232448;  // a CTA's dynamic shared memory on sm_90

__device__ __forceinline__ float sigmoid_(float z) { return 1.0f / (1.0f + expf(-z)); }
__device__ __forceinline__ double sigmoid_(double z) { return 1.0 / (1.0 + exp(-z)); }
__device__ __forceinline__ float tanh_(float z) { return tanhf(z); }
__device__ __forceinline__ double tanh_(double z) { return tanh(z); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// NB consecutive values in shared memory, as 16-byte vectors where NB fills
// whole vectors (the row's address is then 16-byte aligned).
template <typename F, int NB>
__device__ __forceinline__ void load_rows(const F* p, F (&h)[NB]) {
  if constexpr (sizeof(F) == 4 && NB % 4 == 0) {
#pragma unroll
    for (int v = 0; v < NB / 4; ++v) {
      const float4 q = reinterpret_cast<const float4*>(p)[v];
      h[4 * v] = q.x, h[4 * v + 1] = q.y, h[4 * v + 2] = q.z, h[4 * v + 3] = q.w;
    }
  } else if constexpr (sizeof(F) == 8 && NB % 2 == 0) {
#pragma unroll
    for (int v = 0; v < NB / 2; ++v) {
      const double2 q = reinterpret_cast<const double2*>(p)[v];
      h[2 * v] = q.x, h[2 * v + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NB; ++n) h[n] = p[n];
  }
}

template <typename F, int NB>
__device__ __forceinline__ void store_rows(F* p, const F (&h)[NB]) {
  if constexpr (sizeof(F) == 4 && NB % 4 == 0) {
#pragma unroll
    for (int v = 0; v < NB / 4; ++v)
      reinterpret_cast<float4*>(p)[v] = make_float4(h[4 * v], h[4 * v + 1], h[4 * v + 2],
                                                    h[4 * v + 3]);
  } else if constexpr (sizeof(F) == 8 && NB % 2 == 0) {
#pragma unroll
    for (int v = 0; v < NB / 2; ++v)
      reinterpret_cast<double2*>(p)[v] = make_double2(h[2 * v], h[2 * v + 1]);
  } else {
#pragma unroll
    for (int n = 0; n < NB; ++n) p[n] = h[n];
  }
}

// dst[k][n] = src[n, k] (rows of `len` values, `nb` of them valid; the rest,
// or all when src is null, zero). Where NB fills 16-byte vectors, thread i
// takes one vector's worth of rows (W of them) of one k: the 8 threads of a
// quarter-warp store 128 contiguous bytes (no bank conflict), and a warp
// reads each row's k in 32-byte runs through L2.
template <typename F, int NB>
__device__ __forceinline__ void stage_rows(F* dst, const F* src, int len, int nb) {
  constexpr int V = 16 / sizeof(F);
  constexpr int W = NB % V == 0 ? V : 1;        // rows a thread
  constexpr int G = NB / W;                     // threads a k
#pragma unroll 4
  for (int i = threadIdx.x; i < len * G; i += THREADS) {
    const int k = i / G, n0 = (i - k * G) * W;
    F v[W];
#pragma unroll
    for (int r = 0; r < W; ++r)
      v[r] = src != nullptr && n0 + r < nb ? __ldcg(src + (size_t)(n0 + r) * len + k) : F(0);
    store_rows<F, W>(dst + (size_t)k * NB + n0, v);
  }
}

// Four consecutive values (16-byte aligned) as one or two vector loads.
template <typename F>
__device__ __forceinline__ void load4(const F* p, F (&v)[4]) {
  if constexpr (sizeof(F) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
}

template <typename F>
__device__ __forceinline__ void store4(F* p, const F (&v)[4]) {
  if constexpr (sizeof(F) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
}

// Sum acc over the lanes of a warp that are `width` apart (width a power of
// two): a fixed butterfly, so every lane of a group ends with the same sum.
template <typename F, int NB>
__device__ __forceinline__ void fold_lanes(F (&acc)[NB], int width) {
  for (int off = width; off < 32; off <<= 1) {
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], off);
  }
}

// Values of the forward's staged rows, rounded up to whole 16-byte vectors so
// that the warps' sums after them are stored as vectors.
__host__ __device__ __forceinline__ size_t staged_values(int H, int nb) {
  return ((size_t)H * nb + 3) / 4 * 4;
}

// The CTA's rows: row group blockIdx.y of R, ceil(B / R) rows each (the last
// group may hold fewer, or none).
struct Rows {
  int first, count, stride;
};

__device__ __forceinline__ Rows cta_rows(int B, int R) {
  const int per = (B + R - 1) / R, first = blockIdx.y * per;
  return {first, max(0, min(per, B - first)), per};
}

// The forward: grid (ceil(H / U), R) CTAs of THREADS, one cooperative launch.
// CTA (x, y) owns hidden units [x U, x U + U) of row group y. Thread (grp,
// split) sums the product's four consecutive columns 4 grp .. 4 grp + 3 of NB
// rows over k = split, split + SPLITS, ..: each h value feeds four FMAs and
// each w_h value NB. gates/cs null: inference (nothing saved).
template <typename F, int NB, bool WS>
__global__ void __launch_bounds__(THREADS, 1)
lstm_forward_kernel(const F* __restrict__ xp, const F* __restrict__ w_h,
                    const uint8_t* __restrict__ mask, F* ys, F* __restrict__ gates,
                    F* __restrict__ cs, int T, int B, int H, int U, int R, int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int COLS = 4 * U, CG = U, SPLITS = THREADS / CG;
  const size_t H4 = 4 * (size_t)H;
  const Rows rw = cta_rows(B, R);
  F* ws = reinterpret_cast<F*>(smem_raw);        // [H][4U]: w_h's columns of the units
  F* hs = ws + (WS ? (size_t)H * COLS : 0);      // [H][NB]: h_{t-1} of NB rows
  F* part = hs + staged_values(H, NB);           // [WARPS][NB][4U]: the warps' sums
  F* zsum = part + WARPS * NB * COLS;            // [NB][4U]: the product
  F* c_s = zsum + NB * COLS;                     // [rows][U]: the cell state
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid % CG, split = tid / CG;
  const int j0 = blockIdx.x * U;
  if constexpr (WS) {
    for (int i = tid; i < H * COLS; i += THREADS) {
      const int k = i / COLS, cc = i - k * COLS, j = j0 + cc % U;
      ws[i] = j < H ? w_h[(size_t)k * H4 + (size_t)(cc / U) * H + j] : F(0);
    }
  }
  // the thread's four columns in w_h, for the L2 route (column c: gate c / U,
  // unit j0 + c % U)
  size_t w_at[4];
  bool w_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * grp + i;
    w_at[i] = (size_t)(c / U) * H + j0 + c % U;
    w_in[i] = j0 + c % U < H;
  }
  for (int i = tid; i < rw.count * U; i += THREADS) c_s[i] = F(0);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  PHASES_BEGIN

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const F* h_prev = step == 0 ? nullptr : ys + (size_t)(reverse ? t + 1 : t - 1) * B * H;
    for (int b0 = 0; b0 < rw.count; b0 += NB) {
      const int nb = min(NB, rw.count - b0);
      // the cell element (row n, unit u) of this thread, if any (NB U <= THREADS):
      // its xp and mask are loaded now, under the staging and the product
      const int n_c = tid / U, u_c = tid - n_c * U, j_c = j0 + u_c;
      const bool cell = n_c < nb && j_c < H;
      const size_t row_c = (size_t)t * B + rw.first + b0 + n_c;
      F xq[4];
      bool m_c = false;
      if (cell) {
#pragma unroll
        for (int q = 0; q < 4; ++q) xq[q] = __ldg(xp + row_c * H4 + (size_t)q * H + j_c);
        m_c = mask[row_c] != 0;
      }
      stage_rows<F, NB>(hs, h_prev != nullptr ? h_prev + (size_t)(rw.first + b0) * H : nullptr,
                        H, nb);
      __syncthreads();
      PHASE(0)                                   // staging
      F acc[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = F(0);
      if (h_prev != nullptr) {
#pragma unroll 2
        for (int k = split; k < H; k += SPLITS) {
          F w[4];
          if constexpr (WS) {
            load4<F>(ws + (size_t)k * COLS + 4 * grp, w);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) w[i] = w_in[i] ? __ldg(w_h + k * H4 + w_at[i]) : F(0);
          }
          F h[NB];
          load_rows<F, NB>(hs + (size_t)k * NB, h);
#pragma unroll
          for (int n = 0; n < NB; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[n][i] = fma_(h[n], w[i], acc[n][i]);
        }
      }
      fold_lanes<F, NB * 4>(reinterpret_cast<F(&)[NB * 4]>(acc), CG);
      if (lane < CG) {
#pragma unroll
        for (int n = 0; n < NB; ++n)
          store4<F>(part + (size_t)(warp * NB + n) * COLS + 4 * grp, acc[n]);
      }
      __syncthreads();
      PHASE(1)                                   // the product
      for (int e = tid; e < NB * COLS; e += THREADS) {   // the warps' sums, in warp order
        F s = F(0);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += part[w * NB * COLS + e];
        zsum[e] = s;
      }
      __syncthreads();
      PHASE(2)                                   // the warps' sums

      if (cell) {
        F z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = xq[q] + zsum[n_c * COLS + q * U + u_c];
        const F ig = sigmoid_(z[0]), fg = sigmoid_(z[1]), gg = tanh_(z[2]), og = sigmoid_(z[3]);
        const int e = (b0 + n_c) * U + u_c;
        const F c_old = c_s[e];
        const F c_new = fg * c_old + ig * gg;
        const F h_new = og * tanh_(c_new);
        const F c_keep = m_c ? c_new : c_old;
        c_s[e] = c_keep;
        ys[row_c * H + j_c] = m_c ? h_new : hs[(size_t)j_c * NB + n_c];
        if (gates != nullptr) {
          F* gr = gates + row_c * H4 + j_c;
          gr[0] = ig, gr[H] = fg, gr[2 * (size_t)H] = gg, gr[3 * (size_t)H] = og;
          cs[row_c * H + j_c] = c_keep;
        }
      }
      __syncthreads();
      PHASE(3)                                   // the cell
    }
    if (step + 1 < T) grid.sync();
    PHASE(4)                                     // the barrier
  }
  PHASES_END(0)
}

// A CTA's rows from which the forward's f32 product takes the tensor cores
// (0: never). Measured on an H100 (tools/torch_lstm_phases.py builds both
// routes, H = 512; PERF.md, row 12): FMAs ahead at 1, 2 and 4 rows a CTA,
// the tensor cores at 6, 8 and 24.
#ifndef LSTM_FWD_TC_ROWS
#define LSTM_FWD_TC_ROWS 6
#endif

// The forward's tensor-core layout (U in {4, 8, 16}, H % 4 == 0): M = the
// CTA's 4U columns in MB = U / 4 m-blocks of 16, K = H padded to KP (a
// multiple of 32) in KS = KP / 8 k-steps, N = the CTA's rows (at most 32) in
// n-blocks of 8. A fragment's k column t is read as k = 8 ks + 2 t and t + 4
// as 8 ks + 2 t + 1 (a sum over k takes its k in any order, so long as A's
// columns and B's rows agree), so that a lane's B fragment, split, is one
// 16-byte word of a staged row: the staged rows are [NT8][SP] with pair p =
// k / 2 of a row at 4 p as (hi 2p, hi 2p+1, lo 2p, lo 2p+1) (SP = 2 KP + 16:
// a quarter-warp's 16-byte reads hit distinct banks). After the product the
// same words hold the K-parts' sums [S][NT8][PS] (PS = 4U + 4: a fragment's
// stores hit distinct banks); S = 16 / MB K-parts, one a warp of each m-block.
__host__ __device__ constexpr int tc_kp(int H) { return (H + 31) / 32 * 32; }
__host__ __device__ constexpr int tc_parts(int U) { return WARPS / (U / 4); }
constexpr int TC_NT = 32;                        // rows a CTA, at most: 4 n-blocks
constexpr int TC_LD = 8;                         // 16-byte loads a thread a frame, at most
constexpr int TC_KG = 8;                         // k-steps summed on the tensor cores a time

// Shared memory of the tensor-core route, in bytes: the A fragments, the
// CTA's `rows` staged (rounded up to 8) or the K-parts' sums in their place,
// and the rows' cell state.
size_t tc_forward_bytes(int rows, int H, int U) {
  const size_t nt8 = (rows + 7) / 8 * 8, staged = nt8 * (2 * tc_kp(H) + 16),
               sums = (size_t)tc_parts(U) * nt8 * (4 * U + 4);
  return sizeof(float) * ((size_t)tc_kp(H) * 4 * U + (staged > sums ? staged : sums) +
                          (size_t)rows * U);
}

// One k-step of a warp's tile: p[i] += A(ks) B_i(ks) for its NBK n-blocks,
// A the fragment of w_h's slice at wa[32 ks] (split as csrc/mma_tf32x3.cuh
// splits), B_i the staged pair of n-block i at column 16 ks of hb, split.
template <int NBK>
__device__ __forceinline__ void tc_kstep(float (&p)[NBK][4], const float4* wa, const float* hb,
                                         int SP, int ks) {
  const float4 w = wa[32 * ks];
  FragA a;
  set_a(a, w.x, w.y, w.z, w.w);
  FragB b[NBK];
#pragma unroll
  for (int i = 0; i < NBK; ++i) {
    const float4 h = *reinterpret_cast<const float4*>(hb + (size_t)8 * i * SP + 16 * ks);
    b[i].hi[0] = __float_as_uint(h.x), b[i].hi[1] = __float_as_uint(h.y);
    b[i].lo[0] = __float_as_uint(h.z), b[i].lo[1] = __float_as_uint(h.w);
  }
  mma_tf32x3<NBK>(p, a, b);
}

// acc += the warp's tile over k-steps [k0, k1): TC_KG k-steps a fresh
// fragment, added to the sum in f32.
template <int NBK>
__device__ __forceinline__ void tc_sum(float (&acc)[NBK][4], const float4* wa, const float* hb,
                                       int SP, int k0, int k1) {
  int ks = k0;
  for (; ks + TC_KG <= k1; ks += TC_KG) {
    float p[NBK][4];
    zero(p);
#pragma unroll
    for (int s = 0; s < TC_KG; ++s) tc_kstep(p, wa, hb, SP, ks + s);
    add_to(acc, p);
  }
  if (ks < k1) {
    float p[NBK][4];
    zero(p);
    for (; ks < k1; ++ks) tc_kstep(p, wa, hb, SP, ks);
    add_to(acc, p);
  }
}

// A warp's tile: its m-block of the CTA's NBK n-blocks over its K-part's
// k-steps [ks0, ks1); once every warp is done with the staged rows, stored
// over them as the part's sums at out: (row 8 i + 2 t + v % 2, column g + 8
// (v / 2)) of the tile.
template <int NBK>
__device__ __forceinline__ void tc_tile(const float4* wa, const float* hb, float* out, int SP,
                                        int PS, int ks0, int ks1) {
  float acc[NBK][4];
  zero(acc);
  tc_sum(acc, wa, hb, SP, ks0, ks1);
  __syncthreads();                               // the staged rows read by every warp
#pragma unroll
  for (int i = 0; i < NBK; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) out[(8 * i + (v & 1)) * PS + 8 * (v >> 1)] = acc[i][v];
}

// The forward on the tensor cores (float32): the grid, the frames, the cell
// and the barrier as `lstm_forward_kernel`'s, all of the CTA's rows (at most
// TC_NT) in one stage a frame: h_{t-1} of its rows read
// through L2 (ld.global.cg, all of a thread's loads in flight at once),
// split and stored as pairs; then warp w takes m-block w % MB of its K-part
// w / MB for every n-block of the rows, A = w_h's slice transposed from the
// fragments in shared memory, TC_KG k-steps summed in a fresh fragment and
// added to the part's sum in f32; the cell adds the S parts in order.
__global__ void __launch_bounds__(THREADS, 1)
lstm_forward_kernel_tc(const float* __restrict__ xp, const float* __restrict__ w_h,
                       const uint8_t* __restrict__ mask, float* ys, float* __restrict__ gates,
                       float* __restrict__ cs, int T, int B, int H, int U, int R, int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int COLS = 4 * U, MB = U / 4, S = tc_parts(U), KP = tc_kp(H), KS = KP / 8;
  const int SP = 2 * KP + 16, PS = COLS + 4, NT8 = ((B + R - 1) / R + 7) / 8 * 8;
  const int HQ = H / 4;
  const size_t H4 = 4 * (size_t)H;
  const Rows rw = cta_rows(B, R);
  float4* wf = reinterpret_cast<float4*>(smem_raw);              // [MB][KS][32]: A fragments
  float* hs = reinterpret_cast<float*>(wf + (size_t)MB * KS * 32);  // [NT8][SP]: h_{t-1}, split
  float* part = hs;                                               // [S][NT8][PS]: the K-parts
  float* c_s = hs + max(NT8 * SP, S * NT8 * PS);                  // [rows][U]: the cell state
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int j0 = blockIdx.x * U;
  // w_h (k, column c: gate c / U, unit j0 + c % U) into lane 4 (c % 8) + (k % 8) / 2 of
  // fragment (c / 16, k / 8), value 2 (k % 2) + (c % 16) / 8; zero past H
  float* wfs = reinterpret_cast<float*>(wf);
  for (int i = tid; i < KP * COLS; i += THREADS) {
    const int k = i / COLS, c = i - k * COLS, m = c & 15, r = k & 7, j = j0 + c % U;
    wfs[(((c >> 4) * KS + (k >> 3)) * 32 + 4 * (m & 7) + (r >> 1)) * 4 + 2 * (r & 1) + (m >> 3)] =
        k < H && j < H ? __ldg(w_h + (size_t)k * H4 + (size_t)(c / U) * H + j) : 0.f;
  }
  for (int i = tid; i < rw.count * U; i += THREADS) c_s[i] = 0.f;
  cg::grid_group grid = cg::this_grid();
  // the warp's index as the compiler can see it is one value a warp (as CUTLASS's
  // canonical_warp_idx_sync): the tile's mma.sync then need no WARPSYNC
  const int wu = __shfl_sync(0xffffffffu, warp, 0);
  const int mb = wu % MB, q = wu / MB, ks0 = q * KS / S, ks1 = (q + 1) * KS / S;
  const float4* wa = wf + (size_t)mb * KS * 32 + lane;
  const float* hb = hs + (size_t)g * SP + 4 * t4;
  float* out = part + ((size_t)q * NT8 + 2 * t4) * PS + 16 * mb + g;
  PHASES_BEGIN

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const float* h_prev = step == 0 ? nullptr : ys + (size_t)(reverse ? t + 1 : t - 1) * B * H;
    // the cell element (row n, unit u) of this thread, if any (rows U <= THREADS):
    // its xp, mask and h_{t-1} are loaded now, under the staging and the product
    const int n_c = tid / U, u_c = tid - n_c * U, j_c = j0 + u_c;
    const bool cell = n_c < rw.count && j_c < H;
    const size_t row_c = (size_t)t * B + rw.first + n_c;
    float xq[4], h_c = 0.f;
    bool m_c = false;
    if (cell) {
#pragma unroll
      for (int gq = 0; gq < 4; ++gq) xq[gq] = __ldg(xp + row_c * H4 + (size_t)gq * H + j_c);
      m_c = mask[row_c] != 0;
      if (h_prev != nullptr) h_c = __ldcg(h_prev + (size_t)(rw.first + n_c) * H + j_c);
    }
    // the CTA's NT8 rows of h_{t-1} (contiguous in ys; zeros at the first frame, past
    // the CTA's rows and past H), split: 4 values a load, two pairs (NT8 KP <= TC_LD
    // THREADS 4); every load in flight before the first store
    const float4* src = reinterpret_cast<const float4*>(
        h_prev != nullptr ? h_prev + (size_t)rw.first * H : ys);
    float4 v[TC_LD];
#pragma unroll
    for (int r = 0; r < TC_LD; ++r) {
      const int i = tid + r * THREADS, n = i / (KP / 4), k4 = i - n * (KP / 4);
      v[r] = h_prev != nullptr && n < rw.count && k4 < HQ ? __ldcg(src + n * HQ + k4)
                                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < TC_LD; ++r) {
      const int i = tid + r * THREADS;
      if (i >= NT8 * KP / 4) break;
      const int n = i / (KP / 4), k4 = i - n * (KP / 4);
      const float x[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[e], lo[e]);
      float4* d = reinterpret_cast<float4*>(hs + (size_t)n * SP + 8 * k4);
      d[0] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]), __uint_as_float(lo[0]),
                         __uint_as_float(lo[1]));
      d[1] = make_float4(__uint_as_float(hi[2]), __uint_as_float(hi[3]), __uint_as_float(lo[2]),
                         __uint_as_float(lo[3]));
    }
    __syncthreads();
    PHASE(0)                                   // staging

    switch (NT8 / 8) {
      case 1: tc_tile<1>(wa, hb, out, SP, PS, ks0, ks1); break;
      case 2: tc_tile<2>(wa, hb, out, SP, PS, ks0, ks1); break;
      case 3: tc_tile<3>(wa, hb, out, SP, PS, ks0, ks1); break;
      default: tc_tile<4>(wa, hb, out, SP, PS, ks0, ks1);
    }
    __syncthreads();
    PHASE(1)                                   // the product
    PHASE(2)                                   // (no warps' sums: the cell adds the parts)

    if (cell) {
      float z[4] = {0.f, 0.f, 0.f, 0.f};
      const float* pz = part + (size_t)n_c * PS + u_c;
#pragma unroll 4
      for (int k = 0; k < S; ++k) {
#pragma unroll
        for (int gq = 0; gq < 4; ++gq) z[gq] += pz[(size_t)k * NT8 * PS + gq * U];
      }
#pragma unroll
      for (int gq = 0; gq < 4; ++gq) z[gq] = xq[gq] + z[gq];
      const float ig = sigmoid_(z[0]), fg = sigmoid_(z[1]), gg = tanh_(z[2]), og = sigmoid_(z[3]);
      const int e = n_c * U + u_c;
      const float c_old = c_s[e];
      const float c_new = fg * c_old + ig * gg;
      const float h_new = og * tanh_(c_new);
      const float c_keep = m_c ? c_new : c_old;
      c_s[e] = c_keep;
      ys[row_c * H + j_c] = m_c ? h_new : h_c;
      if (gates != nullptr) {
        float* gr = gates + row_c * H4 + j_c;
        gr[0] = ig, gr[H] = fg, gr[2 * (size_t)H] = gg, gr[3 * (size_t)H] = og;
        cs[row_c * H + j_c] = c_keep;
      }
    }
    PHASE(3)                                   // the cell
    if (step + 1 < T) grid.sync();
    PHASE(4)                                     // the barrier
  }
  PHASES_END(0)
}

// The backward's layout. The CTA's 4U columns of w_h (column c: gate c / U,
// unit j0 + c % U) are K, in KST k-steps of 8 (CW = 8 KST columns, those past
// 4U zero); w_h's H rows are the units of the partial dh. The FMA route
// holds w_h's rows h = tid, tid + THREADS (HPT of them) over the CW columns
// in registers (f32) and reads dz_t's rows [rows][CW] as broadcast 16-byte
// words. The tensor-core route (LSTM_TC_ROWS rows a CTA or more) takes
// MB = ceil(H / 16) m-blocks of 16 rows, warp w the m-blocks w, w + 16, ..,
// its A fragments stored in shared memory in fragment order (a lane's four
// values one 16-byte word), and dz_t's columns permuted so that a lane reads
// its B fragment's two columns (8 ks + t and 8 ks + t + 4) of a row as one
// 8-byte word: (row n, column c) at (4 n + c % 4) SP + 2 (c / 8) + (c / 4) % 2,
// SP chosen so that the 16 lanes of a half-warp hit distinct banks.
__host__ __device__ constexpr int bwd_kst(int U) { return U >= 2 ? U / 2 : 1; }
// The FMA route's rows of w_h a thread: h = tid, tid + THREADS (HPT of them,
// all of the CW columns in registers: 64 values at most).
__host__ __device__ constexpr int bwd_hpt(int kst) { return kst >= 8 ? 1 : 2; }
__host__ __device__ constexpr int bwd_sp(int kst) { return 2 * kst + (kst > 1 ? 2 : 0); }
__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// The bytes ahead of the partials in the backward's scratch: one arrival
// counter a row group.
constexpr size_t SCRATCH_HEAD = 256;

// A CTA's rows from which the f32 product takes the tensor cores (0: never).
// Measured on an H100 (tools/torch_lstm_phases.py builds both routes, H =
// 512): FMAs ahead at 1, 2 and 4 rows a CTA, even at 6, the tensor cores
// ahead at 8 and 24.
#ifndef LSTM_TC_ROWS
#define LSTM_TC_ROWS 7
#endif

// w_h's element (row h, the CTA's column c), or -1 past H or 4U (zero).
__device__ __forceinline__ long long bwd_w_index(int h, int c, int H, int U, int j0) {
  if (h >= H || c >= 4 * U || j0 + c % U >= H) return -1;
  return (long long)h * 4 * H + (long long)(c / U) * H + j0 + c % U;
}

template <typename F>
__device__ __forceinline__ F bwd_w_load(const F* w_h, int h, int c, int H, int U, int j0) {
  const long long i = bwd_w_index(h, c, H, U, j0);
  return i >= 0 ? __ldg(w_h + i) : F(0);
}

// One value global -> shared without passing through registers (4 or 8
// bytes); with `zero` no byte is read and the value is zero.
template <typename F>
__device__ __forceinline__ void cp_async_value(F* smem, const F* gmem, bool zero) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(s), "l"(gmem),
               "n"((int)sizeof(F)), "r"(zero ? 0 : (int)sizeof(F))
               : "memory");
}

__device__ __forceinline__ void arrive_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

template <typename F>
__device__ __forceinline__ void load2(const F* p, F& a, F& b) {
  if constexpr (sizeof(F) == 4) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    a = q.x, b = q.y;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    a = q.x, b = q.y;
  }
}

// The backward: grid (ceil(H / U), R) CTAs of THREADS, one cooperative
// launch (see the header comment). dxp [T, B, 4H] is written and never read
// back; `part` [2][R][NX reader][NX writer][rows][U] holds the partial dh of
// each CTA (the writer) for the units of each CTA (the reader), by frame
// parity, so that a CTA's partials lie in one block; `counters` [R] the row
// groups' arrivals.
template <typename F, int KST>
__global__ void __launch_bounds__(THREADS, 1)
lstm_backward_kernel(const F* __restrict__ dys, const F* __restrict__ gates,
                     const F* __restrict__ cs, const F* __restrict__ w_h,
                     const int* __restrict__ mask, F* __restrict__ dxp, F* part,
                     unsigned* counters, int T, int B, int H, int U, int R, int reverse,
                     int tc) {
  constexpr int HPT = bwd_hpt(KST), CW = 8 * KST, SP = bwd_sp(KST);
  constexpr bool WREG = sizeof(F) == 4;          // w_h's rows in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Rows rw = cta_rows(B, R);
  const int NX = gridDim.x, MB = (H + 15) / 16, E = rw.count * U, EU = rw.stride * U;
  const size_t H4 = 4 * (size_t)H;
  // [MB][KST][32][4] f32: the A fragments (tensor-core route only)
  float* wf = reinterpret_cast<float*>(smem_raw);
  F* dz_r = reinterpret_cast<F*>(wf + (tc ? (size_t)MB * KST * 128 : 0));  // [round16(rows)][CW]
  F* dz_p = dz_r + (size_t)round16(rw.stride) * CW;   // [round16(rows)][4][SP]: dz_t, permuted
  F* dh_s = dz_p + (size_t)round16(rw.stride) * 4 * SP;   // [rows][U]: the carry dh
  F* dc_s = dh_s + EU;                           // [rows][U]: the carry dc
  F* pre = dc_s + EU;                            // [8][rows][U]: the next cell's inputs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int j0 = blockIdx.x * U, y = blockIdx.y, ush = __ffs(U) - 1;

  // the FMA route: the thread's rows of w_h (h = tid + k THREADS) over the
  // CW columns
  F wr[WREG ? HPT : 1][WREG ? CW : 1];
  if constexpr (WREG) {
#pragma unroll
    for (int k = 0; k < HPT; ++k)
#pragma unroll
      for (int c = 0; c < CW; ++c) wr[k][c] = bwd_w_load(w_h, tid + k * THREADS, c, H, U, j0);
    // the fragments: (h, c), (h + 8, c), (h, c + 4), (h + 8, c + 4) for h =
    // 16 mb + g, c = 8 ks + t
    for (int i = tid; tc && i < MB * KST * 32; i += THREADS) {
      const int ln = i & 31, mb = i / (32 * KST), ks = (i >> 5) % KST;
      const int h = 16 * mb + (ln >> 2), c = 8 * ks + (ln & 3);
      float4 v;
      v.x = bwd_w_load(w_h, h, c, H, U, j0), v.y = bwd_w_load(w_h, h + 8, c, H, U, j0);
      v.z = bwd_w_load(w_h, h, c + 4, H, U, j0), v.w = bwd_w_load(w_h, h + 8, c + 4, H, U, j0);
      reinterpret_cast<float4*>(wf)[i] = v;
    }
  }
  for (int i = tid; i < round16(rw.stride) * (CW + 4 * SP) + 2 * EU; i += THREADS) dz_r[i] = F(0);
  if (blockIdx.x == 0 && tid == 0) counters[y] = 0u;

  // Element e (row e / U, unit e % U) belongs to the lanes [L e', L e' + L)
  // of the pass that holds it (e' = e mod THREADS / L): L, a power of two up
  // to 32, lanes sum its partials; the first of them, its owner, prefetches
  // its cell inputs, runs its cell and keeps its carry, so none of that
  // crosses threads.
  int L = 1;
  while (L < 32 && L < NX && 2 * L * E <= THREADS) L *= 2;
  const int per_pass = THREADS / L, l = tid % L;
  const bool owner = l == 0;

  auto frame = [&](int p) { return reverse ? T - 1 - p : p; };
  // the owned elements' cell inputs of the frame at place p (in processing
  // order) into pre, by cp.async: gates, c, c_{t-1}, dy and the row's mask
  auto prefetch = [&](int p) {
    const int t = frame(p), tp = p > 0 ? frame(p - 1) : t;
    for (int e = tid / L; owner && e < E; e += per_pass) {
      const int n = e / U, j = j0 + e % U;
      if (j >= H) continue;
      const size_t row = (size_t)t * B + rw.first + n;
      const F* gr = gates + row * H4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) cp_async_value(pre + q * EU + e, gr + (size_t)q * H, false);
      cp_async_value(pre + 4 * EU + e, cs + row * H + j, false);
      cp_async_value(pre + 5 * EU + e, cs + ((size_t)tp * B + rw.first + n) * H + j, p == 0);
      cp_async_value(pre + 6 * EU + e, dys + row * H + j, false);
      cp_async_value(reinterpret_cast<int*>(pre + 7 * EU + e), mask + row, false);
    }
    cp_async_commit();
  };
  prefetch(T - 1);
  cg::this_grid().sync();                        // the zeroed counters, before any arrival
  PHASES_BEGIN

  for (int step = 0; step < T; ++step) {
    const int p = T - 1 - step, t = frame(p), par = step & 1;
    cp_async_wait<0>();                          // the owner's own copies
    PHASE(7)                                     // the prefetch's wait

    for (int e = tid / L; owner && e < E; e += per_pass) {
      const int n = e / U, u = e - n * U, j = j0 + u;
      if (j >= H) continue;
      const F ig = pre[e], fg = pre[EU + e], gg = pre[2 * EU + e], og = pre[3 * EU + e];
      const F c = pre[4 * EU + e], c_prev = pre[5 * EU + e];
      const F dh = dh_s[e] + pre[6 * EU + e];
      const bool m = *reinterpret_cast<const int*>(pre + 7 * EU + e) != 0;
      F dz[4] = {F(0), F(0), F(0), F(0)};
      if (m) {
        const F tc = tanh_(c);
        dz[3] = dh * tc * og * (F(1) - og);
        const F dct = dc_s[e] + dh * og * (F(1) - tc * tc);
        dz[0] = dct * gg * ig * (F(1) - ig);
        dz[2] = dct * ig * (F(1) - gg * gg);
        dz[1] = dct * c_prev * fg * (F(1) - fg);
        dc_s[e] = dct * fg;
      }
      dh_s[e] = m ? F(0) : dh;
      F* dr = dxp + ((size_t)t * B + rw.first + n) * H4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dr[(size_t)q * H] = dz[q];
        const int cc = q * U + u;
        dz_r[n * CW + cc] = dz[q];
        if (tc) dz_p[(4 * n + (cc & 3)) * SP + 2 * (cc >> 3) + ((cc >> 2) & 1)] = dz[q];
      }
    }
    PHASE(0)                                     // the cell
    if (p == 0) break;                           // dh before the first frame is not needed
    __syncthreads();                             // dz_t whole
    PHASE(1)                                     // the CTA barrier after the cell

    // the partial dh [rows, H] of this CTA's columns: (row n, unit h) at
    // out + (h / U) NX EU + n U + h % U
    F* out = part + (((size_t)par * R + y) * NX * NX + blockIdx.x) * EU;
    const int xr_stride = NX * EU;
    auto put = [&](int n, int h, F v) { out[(h >> ush) * xr_stride + n * U + (h & (U - 1))] = v; };
    if constexpr (WREG) {
      // tensor cores: an n-block of 8 rows a pass, its K = CW columns summed
      // in the fragment (three products a k-step, small terms first)
      for (int n0 = 0; tc && n0 < rw.count; n0 += 8) {
        constexpr int MBW = 4;                   // m-blocks a warp, at most (H <= 1024)
        float acc[MBW][1][4];
#pragma unroll
        for (int i = 0; i < MBW; ++i) zero(acc[i]);
#pragma unroll
        for (int ks = 0; ks < KST; ++ks) {
          FragB b[1];
          float b0, b1;
          load2(dz_p + (4 * (n0 + g) + t4) * SP + 2 * ks, b0, b1);
          set_b(b[0], b0, b1);
#pragma unroll
          for (int i = 0; i < MBW; ++i) {
            const int mb = warp + 16 * i;
            if (mb >= MB) continue;
            const float4 w = reinterpret_cast<const float4*>(wf)[(mb * KST + ks) * 32 + lane];
            const float x[4] = {w.x, w.y, w.z, w.w};
            FragA a;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              a.hi[v] = __float_as_uint(x[v]) & 0xffffe000u;
              a.lo[v] = __float_as_uint(x[v] - __uint_as_float(a.hi[v]));
            }
            mma_tf32x3<1>(acc[i], a, b);
          }
        }
#pragma unroll
        for (int i = 0; i < MBW; ++i) {
          const int h = 16 * (warp + 16 * i) + g, n = n0 + 2 * t4;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int hv = h + (v >> 1) * 8, nv = n + (v & 1);
            if (hv < H && nv < rw.count) put(nv, hv, acc[i][0][v]);
          }
        }
      }
    }
    if (!tc) {
      // FMAs: RP rows a pass; the thread's HPT rows of w_h against each row
      // of dz_t, read as broadcast 16-byte words
      constexpr int RP = HPT == 1 && sizeof(F) == 4 ? 4 : 2;
      for (int n0 = 0; n0 < rw.count; n0 += RP) {
        F acc[RP][HPT];
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int k = 0; k < HPT; ++k) acc[r][k] = F(0);
#pragma unroll
        for (int c = 0; c < CW; c += 4) {
          F w[HPT][4];
#pragma unroll
          for (int k = 0; k < HPT; ++k)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              if constexpr (WREG) {
                w[k][v] = wr[k][c + v];
              } else {
                w[k][v] = bwd_w_load(w_h, tid + k * THREADS, c + v, H, U, j0);
              }
            }
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            if (n0 + r >= rw.count) break;
            F z[4];
            load4(dz_r + (n0 + r) * CW + c, z);
#pragma unroll
            for (int k = 0; k < HPT; ++k)
              acc[r][k] = fma_(w[k][3], z[3], fma_(w[k][2], z[2], fma_(w[k][1], z[1],
                                                                       fma_(w[k][0], z[0], acc[r][k]))));
          }
        }
#pragma unroll
        for (int k = 0; k < HPT; ++k) {
          const int h = tid + k * THREADS;
#pragma unroll
          for (int r = 0; r < RP; ++r)
            if (h < H && n0 + r < rw.count) put(n0 + r, h, acc[r][k]);
        }
      }
    }
    PHASE(2)                                     // the product
    __syncthreads();                             // every partial stored
    PHASE(3)                                     // the CTA barrier after it
    if (tid == 0) arrive_release(counters + y);  // the bar.sync above makes the release
                                                 // cover every thread's partials
    prefetch(p - 1);                             // the next cell's inputs, under the wait
    if (tid == 0) {
      const unsigned target = (unsigned)NX * (unsigned)(step + 1);
      while (load_relaxed(counters + y) < target) {
      }
      fence_acquire();
    }
    PHASE(4)                                     // the row group's barrier
    __syncthreads();
    PHASE(5)                                     // the CTA barrier after it

    // dh += the group's NX partials of the CTA's units, one block of NX EU
    // values (element e of writer xw at xw EU + e): lane l of the element's
    // L sums writers l, l + L, .. in order (8 loads in flight), then a
    // butterfly over the L lanes, a fixed order; the owner adds the sum
    const F* src = part + (((size_t)par * R + y) * NX + blockIdx.x) * NX * EU;
    for (int e0 = 0; e0 < E; e0 += per_pass) {
      const int e = e0 + tid / L;
      F sum = F(0);
      if (e < E && j0 + e % U < H) {
        for (int x0 = l; x0 < NX; x0 += 8 * L) {
          F v[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int xs = x0 + r * L;
            v[r] = xs < NX ? __ldcg(src + xs * EU + e) : F(0);
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) sum += v[r];
        }
      }
      for (int off = 1; off < L; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (owner && e < E) dh_s[e] += sum;
    }
    PHASE(6)                                     // the sums
  }
  PHASES_END(8)
}

// Shared memory of the forward's plan, in values: the w_h slice (when WS),
// the staged rows, the warps' sums and the product, and the cell state of
// the CTA's `rows`.
size_t forward_values(int rows, int H, int U, int nb, bool ws) {
  return (ws ? (size_t)H * 4 * U : 0) + staged_values(H, nb) +
         (size_t)(WARPS + 1) * nb * 4 * U + (size_t)rows * U;
}

// Shared memory of the backward, in bytes: the A fragments (tensor-core
// route), dz_t as rows and permuted, the carry (dh, dc) and the next cell's
// eight inputs (the mask among them).
size_t backward_bytes(size_t value_bytes, int rows, int H, int U, bool tc) {
  const int kst = bwd_kst(U);
  return (tc ? sizeof(float) * 128 * (size_t)((H + 15) / 16) * kst : 0) +
         value_bytes * ((size_t)round16(rows) * (8 * kst + 4 * bwd_sp(kst)) + (size_t)10 * rows * U);
}

bool valid(int T, int B, int H, int U, int R) {
  return T >= 1 && B >= 1 && H >= 1 && H <= MAX_H && R >= 1 && R <= B &&
         (U == 1 || U == 2 || U == 4 || U == 8 || U == 16);
}

// Whether the backward takes (U, R) at (B, H): w_h's rows within the
// threads' registers (HPT a thread) and the row group's state within shared
// memory; with `tc` whether the product takes the tensor cores (float32,
// LSTM_TC_ROWS rows a CTA or more, the A fragments within shared memory).
bool backward_fits(size_t value_bytes, int B, int H, int U, int R, size_t* smem, bool* tc) {
  const int rows = (B + R - 1) / R;
  if (H > THREADS * bwd_hpt(bwd_kst(U))) return false;
  *tc = value_bytes == 4 && LSTM_TC_ROWS > 0 && rows >= LSTM_TC_ROWS &&
        backward_bytes(value_bytes, rows, H, U, true) <= MAX_SMEM;
  *smem = backward_bytes(value_bytes, rows, H, U, *tc);
  return *smem <= MAX_SMEM;
}

// Rows a stage and w_h's place for the forward's grid. From LSTM_FWD_TC_ROWS
// rows a CTA in float32 (U >= 4, H % 4 == 0) the tensor cores (`tc`), where
// all of the CTA's rows fit one stage beside the slice's fragments in shared
// memory (at most TC_NT rows, rows U <= THREADS). Otherwise FMAs: the slice
// in shared memory where it fits, then the most rows a stage that fit beside
// it (up to 16 in float32 and 4 in float64, where four columns of NB rows of
// sums take the registers; no more than the CTA's rows need).
bool stage_plan(size_t value_bytes, int B, int H, int U, int R, int* nb, bool* ws, bool* tc,
                size_t* smem) {
  const int rows = (B + R - 1) / R, cap = value_bytes == 8 ? 4 : 16;
  *tc = false;
  if (value_bytes == 4 && LSTM_FWD_TC_ROWS > 0 && rows >= LSTM_FWD_TC_ROWS && U >= 4 &&
      H % 4 == 0) {
    const size_t bytes = tc_forward_bytes(rows, H, U);
    if (rows <= TC_NT && rows * U <= THREADS &&
        (rows + 7) / 8 * 8 * tc_kp(H) <= 4 * TC_LD * THREADS && bytes <= MAX_SMEM) {
      *nb = rows, *ws = true, *tc = true, *smem = bytes;
      return true;
    }
  }
  int top = 1;
  while (top < cap && top < rows) top *= 2;
  for (int w = 1; w >= 0; --w) {
    for (int n = top; n >= 1; n /= 2) {
      const size_t bytes = value_bytes * forward_values(rows, H, U, n, w);
      if (bytes <= MAX_SMEM) {
        *nb = n, *ws = w != 0, *smem = bytes;
        return true;
      }
    }
  }
  return false;
}

// The grid: R row groups of ceil(H / U) CTAs, at most one CTA an SM. The most
// row groups (up to 4, no more than B) for which the smallest U that keeps the
// grid within the SMs also takes the kernel's plan (forward: w_h's slice in
// shared memory, so each CTA stages only its row group's h_{t-1} a frame;
// backward: `backward_fits`, so each CTA reads only its row group's
// partials). One group where none does.
bool grid_plan(bool backward, size_t value_bytes, int B, int H, int* U, int* R) {
  int sms = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  for (int r = 4; r >= 1; r /= 2) {
    if (r > B) continue;
    for (int u = 1; u <= 16; u *= 2) {
      if ((H + u - 1) / u * r > sms) continue;
      int nb;
      bool ws, tc;
      size_t smem;
      if (backward ? backward_fits(value_bytes, B, H, u, r, &smem, &ws)
                   : stage_plan(value_bytes, B, H, u, r, &nb, &ws, &tc, &smem) && (ws || r == 1)) {
        *U = u, *R = r;
        return true;
      }
      break;
    }
  }
  return false;
}

int cooperative(const void* kernel, dim3 grid, void** args, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, grid, dim3(THREADS), args, smem, st);
  cudaGetLastError();  // a refused launch leaves no sticky error behind
  return (int)e;
}

template <typename F, int NB, bool WS>
int forward_nb(const void* xp, const void* w_h, const void* mask, void* ys, void* gates,
               void* cs, int T, int B, int H, int U, int R, int reverse, size_t smem,
               cudaStream_t st) {
  if constexpr (sizeof(F) == 8 && NB > 4) {
    return (int)cudaErrorInvalidValue;           // no plan takes it
  } else {
    const F* a_xp = static_cast<const F*>(xp);
    const F* a_w = static_cast<const F*>(w_h);
    const uint8_t* a_m = static_cast<const uint8_t*>(mask);
    F* a_ys = static_cast<F*>(ys);
    F* a_g = static_cast<F*>(gates);
    F* a_c = static_cast<F*>(cs);
    void* args[] = {&a_xp, &a_w, &a_m, &a_ys, &a_g, &a_c, &T, &B, &H, &U, &R, &reverse};
    return cooperative((const void*)lstm_forward_kernel<F, NB, WS>, dim3((H + U - 1) / U, R),
                       args, smem, st);
  }
}

int forward_tc(const void* xp, const void* w_h, const void* mask, void* ys, void* gates,
               void* cs, int T, int B, int H, int U, int R, int reverse, size_t smem,
               cudaStream_t st) {
  const float* a_xp = static_cast<const float*>(xp);
  const float* a_w = static_cast<const float*>(w_h);
  const uint8_t* a_m = static_cast<const uint8_t*>(mask);
  float* a_ys = static_cast<float*>(ys);
  float* a_g = static_cast<float*>(gates);
  float* a_c = static_cast<float*>(cs);
  void* args[] = {&a_xp, &a_w, &a_m, &a_ys, &a_g, &a_c, &T, &B, &H, &U, &R, &reverse};
  return cooperative((const void*)lstm_forward_kernel_tc, dim3((H + U - 1) / U, R), args, smem,
                     st);
}

template <typename F, int KST>
int backward_kst(const void* dys, const void* gates, const void* cs, const void* w_h,
                 const void* mask, void* dxp, void* scratch, int T, int B, int H, int U, int R,
                 int reverse, int tc, size_t smem, cudaStream_t st) {
  const F* a_dy = static_cast<const F*>(dys);
  const F* a_g = static_cast<const F*>(gates);
  const F* a_c = static_cast<const F*>(cs);
  const F* a_w = static_cast<const F*>(w_h);
  const int* a_m = static_cast<const int*>(mask);
  F* a_dx = static_cast<F*>(dxp);
  unsigned* a_ctr = static_cast<unsigned*>(scratch);
  F* a_part = reinterpret_cast<F*>(static_cast<char*>(scratch) + SCRATCH_HEAD);
  void* args[] = {&a_dy, &a_g, &a_c, &a_w, &a_m, &a_dx, &a_part, &a_ctr,
                  &T, &B, &H, &U, &R, &reverse, &tc};
  return cooperative((const void*)lstm_backward_kernel<F, KST>, dim3((H + U - 1) / U, R), args,
                     smem, st);
}

template <typename F>
int backward_typed(const void* dys, const void* gates, const void* cs, const void* w_h,
                   const void* mask, void* dxp, void* scratch, int T, int B, int H, int U, int R,
                   int reverse, int tc, size_t smem, cudaStream_t st) {
#define LSTM_BWD(KST_)                                                                      \
  return backward_kst<F, KST_>(dys, gates, cs, w_h, mask, dxp, scratch, T, B, H, U, R, reverse, \
                               tc, smem, st);
  switch (bwd_kst(U)) {
    case 1: LSTM_BWD(1)
    case 2: LSTM_BWD(2)
    case 4: LSTM_BWD(4)
    default: LSTM_BWD(8)
  }
#undef LSTM_BWD
}

// One instantiation a (rows a stage, w_h in shared memory) pair.
#define LSTM_CASE(FN, F, NB_, WS_, ...) \
  return WS_ ? FN<F, NB_, true>(__VA_ARGS__) : FN<F, NB_, false>(__VA_ARGS__);
#define LSTM_DISPATCH(FN, F, NB_, WS_, ...)                      \
  switch (NB_) {                                                 \
    case 1: LSTM_CASE(FN, F, 1, WS_, __VA_ARGS__)                \
    case 2: LSTM_CASE(FN, F, 2, WS_, __VA_ARGS__)                \
    case 4: LSTM_CASE(FN, F, 4, WS_, __VA_ARGS__)                \
    case 8: LSTM_CASE(FN, F, 8, WS_, __VA_ARGS__)                \
    default: LSTM_CASE(FN, F, 16, WS_, __VA_ARGS__)              \
  }

}  // namespace

extern "C" {

// The grid the kernels take at (B, H) on the current device: U hidden units a
// CTA and R row groups (the grid is ceil(H / U) x R). Returns 0 when no grid
// fits (B's per-unit state past shared memory).
int masked_lstm_grid(int backward, int B, int H, int f64, int* U, int* R) {
  return grid_plan(backward != 0, f64 ? 8 : 4, B, H, U, R) ? 1 : 0;
}

// ys [T, B, H] for xp [T, B, 4H], w_h [H, 4H] (float64 when f64 != 0, else
// float32) and mask [T, B] (one byte a frame, nonzero = valid); gates
// [T, B, 4H] and cs [T, B, H] are written when not null (training). The grid
// is ceil(H / U) x R (masked_lstm_grid's, or any U in {1, 2, 4, 8, 16} and
// 1 <= R <= B). One cooperative launch on `stream`; returns 0 or the CUDA
// error (cudaErrorInvalidValue when the shapes or the plan do not fit,
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident at once).
// *tensor_cores, when not null, is set to whether the product takes the
// tensor cores (`stage_plan`'s route) before the launch.
int masked_lstm_forward(const void* xp, const void* w_h, const void* mask, void* ys,
                        void* gates, void* cs, int T, int B, int H, int U, int R, int reverse,
                        int f64, void* stream, int* tensor_cores) {
  int nb;
  bool ws, tc;
  size_t smem;
  if (!valid(T, B, H, U, R) || (gates == nullptr) != (cs == nullptr) ||
      !stage_plan(f64 ? 8 : 4, B, H, U, R, &nb, &ws, &tc, &smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tensor_cores != nullptr) *tensor_cores = tc;
  if (tc) return forward_tc(xp, w_h, mask, ys, gates, cs, T, B, H, U, R, reverse, smem, st);
  if (f64) {
    LSTM_DISPATCH(forward_nb, double, nb, ws, xp, w_h, mask, ys, gates, cs, T, B, H, U, R,
                  reverse, smem, st)
  }
  LSTM_DISPATCH(forward_nb, float, nb, ws, xp, w_h, mask, ys, gates, cs, T, B, H, U, R,
                reverse, smem, st)
}

// The bytes of scratch `masked_lstm_backward` takes at (B, H) on the grid
// (U, R): the row groups' counters and two frames of every CTA's partial dh
// (-1 outside the domain). The caller allocates it each call, on the call's
// stream; its contents need not be set.
long long masked_lstm_backward_scratch(int B, int H, int U, int R, int f64) {
  if (!valid(1, B, H, U, R)) return -1;
  const long long rows = (B + R - 1) / R, nx = (H + U - 1) / U;
  return (long long)SCRATCH_HEAD + 2LL * R * nx * nx * rows * U * (f64 ? 8 : 4);
}

// dxp [T, B, 4H] for the upstream gradient dys [T, B, H] and the training
// forward's gates [T, B, 4H] and cs [T, B, H] (with the same w_h, reverse
// and type, and its mask as int32 [T, B], nonzero = valid, which the
// backward copies into shared memory a word a row); `scratch` holds
// masked_lstm_backward_scratch's bytes.
// The grid (U, R) is masked_lstm_grid's (backward), or any that
// `backward_fits`. One cooperative launch on `stream`; returns as above.
int masked_lstm_backward(const void* dys, const void* gates, const void* cs, const void* w_h,
                         const void* mask, void* dxp, void* scratch, int T, int B, int H, int U,
                         int R, int reverse, int f64, void* stream) {
  size_t smem;
  bool tc;
  if (!valid(T, B, H, U, R) || scratch == nullptr ||
      !backward_fits(f64 ? 8 : 4, B, H, U, R, &smem, &tc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return backward_typed<double>(dys, gates, cs, w_h, mask, dxp, scratch, T, B, H, U, R,
                                  reverse, 0, smem, st);
  return backward_typed<float>(dys, gates, cs, w_h, mask, dxp, scratch, T, B, H, U, R, reverse,
                               tc, smem, st);
}

#if LSTM_PHASES
// The phase times of the last launches (16 values, ns summed over frames).
int masked_lstm_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));
}
#endif

// The plan a grid takes, for the record: rows a stage (the backward: the
// CTA's rows, all of them at once), whether w_h's slice sits in shared memory
// (the backward: its tensor-core fragments, when the product takes the
// tensor cores; its FMA route holds w_h's rows in registers in float32 and
// reads them from L2 in float64), whether the product takes the tensor cores,
// and the bytes of shared memory a CTA (returns 0 when no plan fits).
int masked_lstm_plan(int backward, int B, int H, int U, int R, int f64, int* nb, int* ws,
                     int* tc, long long* smem) {
  bool w = false, c = false;
  size_t s = 0;
  *nb = 0;
  if (!valid(1, B, H, U, R)) return 0;
  if (backward) {
    if (!backward_fits(f64 ? 8 : 4, B, H, U, R, &s, &w)) return 0;
    *nb = (B + R - 1) / R;
    c = w;
  } else if (!stage_plan(f64 ? 8 : 4, B, H, U, R, nb, &w, &c, &s)) {
    return 0;
  }
  *ws = w, *tc = c, *smem = (long long)s;
  return 1;
}

}  // extern "C"
