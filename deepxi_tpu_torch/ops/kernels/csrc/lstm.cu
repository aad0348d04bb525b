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
// the f32 peak, and at B = 1 a frame is a few hundred ns of latency. The
// design keeps everything that does not have to cross CTAs on chip:
//   * One cooperative launch a call (cudaLaunchCooperativeKernel: the launch
//     is refused, never hung, when its grid cannot be resident at once). The
//     grid is ceil(H / U) x R CTAs, at most one an SM: CTA (x, y) owns hidden
//     units [x U, x U + U) of row group y (ceil(B / R) batch rows) for all T
//     frames, so the cell state (forward) and the carry (dh, dc) (backward)
//     of its units stay in shared memory, and its slice of w_h is loaded
//     into shared memory once: the 4U columns [H, 4U] (forward) or the U
//     rows [U, 4H] (backward), 128 KiB in f32 at H = 512, U = 16. Where no
//     slice fits (float64 at large H) the same kernel reads it from L2
//     (template flag WS = false). More row groups (R up to 4, with U as
//     large as the SMs then need) mean each CTA stages fewer rows a frame.
//   * Each frame ends at one grid-wide barrier (cooperative_groups'
//     grid.sync(), ~1.1 us on this card, which orders the frame's global
//     writes before every CTA's reads after it). Forward: every CTA stages
//     h_{t-1} of its rows (= ys of the previous frame, written by the row
//     group's CTAs) NB rows at a time into shared memory as [H][NB], computes
//     its 4U columns of the product, applies the cell to its units and writes
//     ys[t]. Backward: every CTA applies the cell's backward to its units and
//     writes its columns of dxp[t]; after the barrier it stages dz_t of its
//     rows (every CTA's columns) NB rows at a time as they lie, [NB][4H], and
//     reduces dz_t w_h^T over 4H for its units into dh. Each thread's share
//     of the cell (its xp and mask, or its saved gates and state) is loaded
//     in one go ahead of the arithmetic.
//   * The product: 512 threads (16 warps) on f32 or f64 FMAs on the CUDA
//     cores (no tensor cores), blocked in registers so that shared memory is
//     not the limit: a forward thread sums four columns of NB rows (each h
//     value feeds four FMAs, each w_h value NB), a backward thread four
//     consecutive columns of dz for up to four units; operands are read as
//     16-byte vectors. A thread takes an interleaved share of the reduction;
//     the lanes of a warp that share columns fold by shuffles, the 16 warps'
//     sums meet in shared memory and are added in warp order. Fixed orders
//     and no atomics: a second call is bitwise equal.
//   * h_{t-1} and dz_t, written during the launch, are read with ld.global.cg
//     (L2, never a stale L1 line); xp, w_h and the saved state are read-only.
// Domain: float32 or float64, 1 <= H <= 1024, B >= 1, T >= 1, U in {1, 2, 4,
// 8, 16}, 1 <= R <= B; B is bounded by the shared memory the per-unit state of
// a row group takes. The caller checks the domain (kernel_takes) and raises
// outside it; a plan that does not fit returns cudaErrorInvalidValue, a grid
// that cannot be resident cudaErrorCooperativeLaunchTooLarge.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Phase times for tools/torch_lstm_phases.py, built only with -DLSTM_PHASES=1:
// thread 0 of CTA (0, 0) adds the %globaltimer ns each phase of each frame
// takes (the forward's into g_phase_ns[0..4], the backward's into [8..12]).
#if LSTM_PHASES
__device__ unsigned long long g_phase_ns[16];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASES_BEGIN unsigned long long phase_ns[5] = {0, 0, 0, 0, 0}, phase_t0 = now_ns();
#define PHASE(i)                                                              \
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {               \
    const unsigned long long t1 = now_ns();                                   \
    phase_ns[i] += t1 - phase_t0;                                             \
    phase_t0 = t1;                                                            \
  }
#define PHASES_END(at)                                                        \
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)                 \
    for (int i = 0; i < 5; ++i) g_phase_ns[(at) + i] = phase_ns[i];
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
__device__ __forceinline__ void load4_cg(const F* p, F (&v)[4]) {
  if constexpr (sizeof(F) == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcg(reinterpret_cast<const double2*>(p) + 1);
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

// The backward: the same grid; dxp [T, B, 4H] is written, one frame a step,
// and read back by every CTA of the row group after the frame's barrier. dz_t
// is staged as it lies, [NB][4H] (16-byte loads and stores). Thread (ug,
// split) reduces over four consecutive columns a step for UG = min(U, 4)
// units: each staged dz value feeds UG units' FMAs, w_h's rows are read as
// 16-byte vectors.
template <typename F, int NB, bool WS>
__global__ void __launch_bounds__(THREADS, 1)
lstm_backward_kernel(const F* __restrict__ dys, const F* __restrict__ gates,
                     const F* __restrict__ cs, const F* __restrict__ w_h,
                     const uint8_t* __restrict__ mask, F* dxp, int T, int B, int H, int U,
                     int R, int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int UG = min(U, 4), NUG = U / UG, SPLITS = THREADS / NUG;
  const int H4 = 4 * H;
  const Rows rw = cta_rows(B, R);
  F* wt = reinterpret_cast<F*>(smem_raw);        // [U][4H]: w_h's rows of the units
  F* zs = wt + (WS ? (size_t)H4 * U : 0);        // [NB][4H]: dz_t of NB rows
  F* part = zs + (size_t)H4 * NB;                // [WARPS][NB][U]
  F* dh_s = part + WARPS * NB * U;               // [rows][U]: the carry dh
  F* dc_s = dh_s + (size_t)rw.stride * U;        // [rows][U]: the carry dc
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ug = tid % NUG, split = tid / NUG;
  const int j0 = blockIdx.x * U;
  if constexpr (WS) {
    for (int i = tid; i < H4 * U; i += THREADS) {
      const int u = i / H4;
      wt[i] = j0 + u < H ? w_h[(size_t)j0 * H4 + i] : F(0);
    }
  }
  for (int i = tid; i < 2 * rw.stride * U; i += THREADS) dh_s[i] = F(0);
  __syncthreads();
  // the thread's UG rows of w_h (null past H: their sums stay zero)
  const F* wrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = ug * UG + i;
    wrow[i] = i < UG && j0 + u < H ? (WS ? wt + (size_t)u * H4 : w_h + (size_t)(j0 + u) * H4)
                                   : nullptr;
  }
  cg::grid_group grid = cg::this_grid();
  PHASES_BEGIN

  for (int step = 0; step < T; ++step) {
    const int p = T - 1 - step;                  // the frame's place in processing order
    const int t = reverse ? T - 1 - p : p;
    const int tp = reverse ? t + 1 : t - 1;      // the frame before it (p > 0)
    for (int e = tid; e < rw.count * U; e += THREADS) {
      const int b = rw.first + e / U, j = j0 + e % U;
      if (j >= H) continue;
      const size_t row = (size_t)t * B + b;
      // every load of the element first (one round trip), then the math
      const F* gr = gates + row * (size_t)H4 + j;
      const F ig = gr[0], fg = gr[H], gg = gr[2 * (size_t)H], og = gr[3 * (size_t)H];
      const F c = cs[row * H + j];
      const F c_prev = p > 0 ? cs[((size_t)tp * B + b) * H + j] : F(0);
      const F dh = dh_s[e] + dys[row * H + j];
      const bool m = mask[row] != 0;
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
      F* dr = dxp + row * (size_t)H4 + j;
      dr[0] = dz[0], dr[H] = dz[1], dr[2 * (size_t)H] = dz[2], dr[3 * (size_t)H] = dz[3];
    }
    PHASE(0)                                     // the cell
    if (p == 0) break;                           // dh before the first frame is not needed
    grid.sync();
    PHASE(1)                                     // the barrier

    for (int b0 = 0; b0 < rw.count; b0 += NB) {
      const int nb = min(NB, rw.count - b0);
      const F* src = dxp + ((size_t)t * B + rw.first + b0) * H4;
#pragma unroll 4
      for (int i = tid; i < NB * H; i += THREADS) {   // NB rows of H groups of 4
        const int n = i / H, c = 4 * (i - n * H);
        F v[4] = {F(0), F(0), F(0), F(0)};
        if (n < nb) load4_cg<F>(src + (size_t)n * H4 + c, v);
        store4<F>(zs + (size_t)n * H4 + c, v);
      }
      __syncthreads();
      PHASE(2)                                   // staging
      F acc[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = F(0);
#pragma unroll 2
      for (int c = 4 * split; c < H4; c += 4 * SPLITS) {
        F w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (wrow[i] != nullptr) {
            load4<F>(wrow[i] + c, w[i]);
          } else {
            w[i][0] = w[i][1] = w[i][2] = w[i][3] = F(0);
          }
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          F z[4];
          load4<F>(zs + (size_t)n * H4 + c, z);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[n][i] = fma_(z[0], w[i][0], fma_(z[1], w[i][1], fma_(z[2], w[i][2],
                                                                  fma_(z[3], w[i][3], acc[n][i]))));
        }
      }
      fold_lanes<F, NB * 4>(reinterpret_cast<F(&)[NB * 4]>(acc), NUG);
      if (lane < NUG) {
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < UG) part[(warp * NB + n) * U + ug * UG + i] = acc[n][i];
      }
      __syncthreads();
      PHASE(3)                                   // the product
      for (int e = tid; e < nb * U; e += THREADS) {
        const int n = e / U, u = e - n * U;
        if (j0 + u >= H) continue;
        F s = F(0);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += part[(w * NB + n) * U + u];
        dh_s[(b0 + n) * U + u] += s;
      }
      __syncthreads();
      PHASE(4)                                   // the warps' sums
    }
  }
  PHASES_END(8)
}

// Shared memory of a plan, in values: the w_h slice (when WS), the staged
// rows, the warps' sums (and the forward's product) and the per-unit state of
// the CTA's `rows`.
size_t forward_values(int rows, int H, int U, int nb, bool ws) {
  return (ws ? (size_t)H * 4 * U : 0) + staged_values(H, nb) +
         (size_t)(WARPS + 1) * nb * 4 * U + (size_t)rows * U;
}

size_t backward_values(int rows, int H, int U, int nb, bool ws) {
  return (ws ? (size_t)4 * H * U : 0) + (size_t)4 * H * nb + (size_t)WARPS * nb * U +
         (size_t)2 * rows * U;
}

bool valid(int T, int B, int H, int U, int R) {
  return T >= 1 && B >= 1 && H >= 1 && H <= MAX_H && R >= 1 && R <= B &&
         (U == 1 || U == 2 || U == 4 || U == 8 || U == 16);
}

// Rows a stage and w_h's place for a grid: the slice in shared memory where it
// fits, then the most rows a stage that fit beside it (up to 16 in float32
// and 4 in float64, where four columns of NB rows of sums take the registers;
// no more than the CTA's rows need).
bool stage_plan(bool backward, size_t value_bytes, int B, int H, int U, int R, int* nb,
                bool* ws, size_t* smem) {
  const int rows = (B + R - 1) / R, cap = value_bytes == 8 ? 4 : 16;
  int top = 1;
  while (top < cap && top < rows) top *= 2;
  for (int w = 1; w >= 0; --w) {
    for (int n = top; n >= 1; n /= 2) {
      const size_t bytes = value_bytes * (backward ? backward_values(rows, H, U, n, w)
                                                   : forward_values(rows, H, U, n, w));
      if (bytes <= MAX_SMEM) {
        *nb = n, *ws = w != 0, *smem = bytes;
        return true;
      }
    }
  }
  return false;
}

// The grid: R row groups of ceil(H / U) CTAs, at most one CTA an SM. The most
// row groups (up to 4, no more than B) for which some U keeps the grid within
// the SMs and w_h's slice in shared memory: each CTA then stages only its row
// group's h_{t-1} (or dz_t) a frame. One group where none does.
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
      bool ws;
      size_t smem;
      if (stage_plan(backward, value_bytes, B, H, u, r, &nb, &ws, &smem) && (ws || r == 1)) {
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

template <typename F, int NB, bool WS>
int backward_nb(const void* dys, const void* gates, const void* cs, const void* w_h,
                const void* mask, void* dxp, int T, int B, int H, int U, int R, int reverse,
                size_t smem, cudaStream_t st) {
  if constexpr (sizeof(F) == 8 && NB > 4) {
    return (int)cudaErrorInvalidValue;           // no plan takes it
  } else {
    const F* a_dy = static_cast<const F*>(dys);
    const F* a_g = static_cast<const F*>(gates);
    const F* a_c = static_cast<const F*>(cs);
    const F* a_w = static_cast<const F*>(w_h);
    const uint8_t* a_m = static_cast<const uint8_t*>(mask);
    F* a_dx = static_cast<F*>(dxp);
    void* args[] = {&a_dy, &a_g, &a_c, &a_w, &a_m, &a_dx, &T, &B, &H, &U, &R, &reverse};
    return cooperative((const void*)lstm_backward_kernel<F, NB, WS>, dim3((H + U - 1) / U, R),
                       args, smem, st);
  }
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

const char* masked_lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
int masked_lstm_forward(const void* xp, const void* w_h, const void* mask, void* ys,
                        void* gates, void* cs, int T, int B, int H, int U, int R, int reverse,
                        int f64, void* stream) {
  int nb;
  bool ws;
  size_t smem;
  if (!valid(T, B, H, U, R) || (gates == nullptr) != (cs == nullptr) ||
      !stage_plan(false, f64 ? 8 : 4, B, H, U, R, &nb, &ws, &smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    LSTM_DISPATCH(forward_nb, double, nb, ws, xp, w_h, mask, ys, gates, cs, T, B, H, U, R,
                  reverse, smem, st)
  }
  LSTM_DISPATCH(forward_nb, float, nb, ws, xp, w_h, mask, ys, gates, cs, T, B, H, U, R,
                reverse, smem, st)
}

// dxp [T, B, 4H] for the upstream gradient dys [T, B, H] and the training
// forward's gates [T, B, 4H] and cs [T, B, H] (with the same w_h, mask,
// reverse and type). One cooperative launch on `stream`; returns as above.
int masked_lstm_backward(const void* dys, const void* gates, const void* cs, const void* w_h,
                         const void* mask, void* dxp, int T, int B, int H, int U, int R,
                         int reverse, int f64, void* stream) {
  int nb;
  bool ws;
  size_t smem;
  if (!valid(T, B, H, U, R) || !stage_plan(true, f64 ? 8 : 4, B, H, U, R, &nb, &ws, &smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    LSTM_DISPATCH(backward_nb, double, nb, ws, dys, gates, cs, w_h, mask, dxp, T, B, H, U, R,
                  reverse, smem, st)
  }
  LSTM_DISPATCH(backward_nb, float, nb, ws, dys, gates, cs, w_h, mask, dxp, T, B, H, U, R,
                reverse, smem, st)
}

#if LSTM_PHASES
// The phase times of the last launches (16 values, ns summed over frames).
int masked_lstm_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));
}
#endif

// The stage plan a grid takes, for the record: rows a stage, whether w_h's
// slice sits in shared memory, and the bytes of shared memory a CTA (returns
// 0 when no plan fits).
int masked_lstm_plan(int backward, int B, int H, int U, int R, int f64, int* nb, int* ws,
                     long long* smem) {
  bool w = false;
  size_t s = 0;
  *nb = 0;
  if (!valid(1, B, H, U, R) || !stage_plan(backward != 0, f64 ? 8 : 4, B, H, U, R, nb, &w, &s))
    return 0;
  *ws = w, *smem = (long long)s;
  return 1;
}

}  // extern "C"
