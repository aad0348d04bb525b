// The masked LSTM recurrence of ResLSTM / ResBiLSTM for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as flax's
// `nn.scan` over `nn.OptimizedLSTMCell` (deepxi_tpu/models/rnn.py:45), which
// XLA compiles into one while-loop. The port needs it as one op so that an
// exported program holds one call a direction a block, not T steps of plain
// operations (ops/kernels/lstm.py).
//
// Per frame t, in processing order (t = 0 .. T-1, or T-1 .. 0 with
// `reverse`), for every batch row b and hidden unit j:
//   z[g] = xp[t, b, g H + j] + sum_k h[b, k] w_h[k, g H + j]   (gates i|f|g|o)
//   c'   = sigmoid(z_f) c + sigmoid(z_i) tanh(z_g)
//   h'   = sigmoid(z_o) tanh(c')
// where the frame's mask is set; where it is not, (c, h) stay as they were.
// ys[t, b, j] is h after the frame. The carry starts at zero. xp already
// holds the input product and the recurrent bias (one matrix product over
// all frames, outside this kernel).
//
// What bounds it on this card: operations. The recurrent product is
// 8 B H^2 FLOP a frame against bytes of xp, ys and w_h once (w_h stays in
// the 50 MB L2 across frames); at reslstm-1.0c's H = 512 and B = 32 the
// FLOPs take 1 us a frame at the f32 peak. This first design is simple to
// check, not fast: one launch a frame, each reading h_{t-1} from ys of the
// previous frame (no ping-pong buffer), c kept in global memory, read and
// written by the one thread that owns (b, j).
//   * A CTA of 8 warps takes COLS = 8 hidden units and NB batch rows. A
//     warp's 32 lanes are (gate, unit) pairs, lane = g * 8 + jj, so for one
//     k a warp reads four 32-byte runs of w_h's row k; warp w sums k = w,
//     w + 8, .. (an eighth of the reduction), each w_h value feeding the NB
//     rows' FMAs (f32 or f64 on the CUDA cores, no tensor cores) from
//     h_{t-1} staged in shared memory as [H][NB], so the NB values of one k
//     are 16-byte vector loads.
//   * The partial sums meet in shared memory; thread (n, jj) of the first
//     NB * 8 adds them in warp order, adds xp and computes the cell.
//   * NB (1, 2, 4, 8 or 16) comes from the host (ops/kernels/lstm.py,
//     `rows_a_block`): enough rows that each w_h load feeds several FMAs,
//     few enough that the grid covers the SMs.
// Domain: float32 or float64, 1 <= H <= 1024, B >= 1, T >= 1; the caller
// checks it (kernel_takes) and raises outside it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int COLS = 8;     // hidden units a CTA
constexpr int SPLITS = 8;   // warps a CTA, each an eighth of the k reduction
constexpr int THREADS = 32 * SPLITS;
constexpr int MAX_H = 1024;

__device__ __forceinline__ float sigmoid_(float z) { return 1.0f / (1.0f + expf(-z)); }
__device__ __forceinline__ double sigmoid_(double z) { return 1.0 / (1.0 + exp(-z)); }
__device__ __forceinline__ float tanh_(float z) { return tanhf(z); }
__device__ __forceinline__ double tanh_(double z) { return tanh(z); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// h_{t-1}[k] of the NB rows, NB consecutive values in shared memory (16-byte
// aligned where NB fills whole vectors): read as 16-byte vectors where it
// can, so a warp's step of the reduction takes NB / 4 (f32) or NB / 2 (f64)
// shared loads, not NB.
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

// One frame. xp [B, 4H] and mask [B] of the frame; h_prev [B, H] is ys of
// the previous frame in processing order, or null at the first (then h and
// c are zero); c [B, H] is read (unless first) and written; y [B, H] is ys
// of this frame.
template <typename F, int NB>
__global__ void __launch_bounds__(THREADS)
lstm_frame_kernel(const F* __restrict__ xp, const F* __restrict__ w_h,
                  const uint8_t* __restrict__ mask, const F* __restrict__ h_prev,
                  F* __restrict__ c, F* __restrict__ y, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F* hs = reinterpret_cast<F*>(smem_raw);  // [H][NB]: h_{t-1} of the CTA's rows
  F* part = hs + NB * H;                   // [SPLITS][NB][32]: partial sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * COLS;
  const int b0 = blockIdx.y * NB;
  const int nb = min(NB, B - b0);

  for (int i = threadIdx.x; i < NB * H; i += THREADS) {
    const int n = i / H, k = i - n * H;
    hs[k * NB + n] = (h_prev != nullptr && n < nb) ? h_prev[(size_t)b0 * H + i] : F(0);
  }
  __syncthreads();

  F acc[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) acc[n] = F(0);
  const int g = lane >> 3, jj = lane & 7;
  const int j = j0 + jj;
  if (j < H && h_prev != nullptr) {
    const size_t H4 = 4 * (size_t)H;
    const F* wcol = w_h + (size_t)g * H + j;
#pragma unroll 8
    for (int k = warp; k < H; k += SPLITS) {
      const F w = __ldg(wcol + (size_t)k * H4);
      F h[NB];
      load_rows<F, NB>(hs + k * NB, h);
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[n] = fma_(h[n], w, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) part[(warp * NB + n) * 32 + lane] = acc[n];
  __syncthreads();

  if (threadIdx.x < NB * COLS) {
    const int n = threadIdx.x / COLS, u = threadIdx.x % COLS;
    const int jc = j0 + u;
    if (n < nb && jc < H) {
      const int b = b0 + n;
      F z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        F s = F(0);
#pragma unroll
        for (int w = 0; w < SPLITS; ++w) s += part[(w * NB + n) * 32 + q * COLS + u];
        z[q] = xp[(size_t)b * 4 * H + (size_t)q * H + jc] + s;
      }
      const size_t o = (size_t)b * H + jc;
      const F c_old = h_prev != nullptr ? c[o] : F(0);
      const F h_old = hs[jc * NB + n];
      const F c_new = sigmoid_(z[1]) * c_old + sigmoid_(z[0]) * tanh_(z[2]);
      const F h_new = sigmoid_(z[3]) * tanh_(c_new);
      const bool m = mask[b] != 0;
      c[o] = m ? c_new : c_old;
      y[o] = m ? h_new : h_old;
    }
  }
}

template <typename F, int NB>
int run(const void* xp_, const void* w_h_, const void* mask_, void* c_, void* ys_, int T,
        int B, int H, int reverse, cudaStream_t st) {
  const F* xp = static_cast<const F*>(xp_);
  const F* w_h = static_cast<const F*>(w_h_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  F* c = static_cast<F*>(c_);
  F* ys = static_cast<F*>(ys_);
  const dim3 grid((H + COLS - 1) / COLS, (B + NB - 1) / NB);
  const size_t smem = ((size_t)NB * H + (size_t)SPLITS * NB * 32) * sizeof(F);
  cudaError_t e = cudaFuncSetAttribute(lstm_frame_kernel<F, NB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const size_t row_h = (size_t)B * H;
  for (int i = 0; i < T; ++i) {
    const int t = reverse ? T - 1 - i : i;
    const F* h_prev = i == 0 ? nullptr : ys + (size_t)(reverse ? t + 1 : t - 1) * row_h;
    lstm_frame_kernel<F, NB><<<grid, THREADS, smem, st>>>(
        xp + (size_t)t * 4 * row_h, w_h, mask + (size_t)t * B, h_prev, c,
        ys + (size_t)t * row_h, B, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename F>
int dispatch(const void* xp, const void* w_h, const void* mask, void* c, void* ys, int T,
             int B, int H, int nb, int reverse, cudaStream_t st) {
  switch (nb) {
    case 1: return run<F, 1>(xp, w_h, mask, c, ys, T, B, H, reverse, st);
    case 2: return run<F, 2>(xp, w_h, mask, c, ys, T, B, H, reverse, st);
    case 4: return run<F, 4>(xp, w_h, mask, c, ys, T, B, H, reverse, st);
    case 8: return run<F, 8>(xp, w_h, mask, c, ys, T, B, H, reverse, st);
    case 16: return run<F, 16>(xp, w_h, mask, c, ys, T, B, H, reverse, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* masked_lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ys [T, B, H] for xp [T, B, 4H], w_h [H, 4H] (float64 when f64 != 0, else
// float32) and mask [T, B] (one byte a frame, nonzero = valid); c [B, H] is
// scratch of the same type. nb rows a CTA (1, 2, 4, 8 or 16). T launches on
// `stream`, in processing order; returns 0 or the first CUDA error.
int masked_lstm_forward(const void* xp, const void* w_h, const void* mask, void* c, void* ys,
                        int T, int B, int H, int nb, int reverse, int f64, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > MAX_H || nb < 1 || (B + nb - 1) / nb > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? dispatch<double>(xp, w_h, mask, c, ys, T, B, H, nb, reverse, st)
             : dispatch<float>(xp, w_h, mask, c, ys, T, B, H, nb, reverse, st);
}

}  // extern "C"
