// Spectral kernels for Hopper (sm_90a), float32 throughout.
//
// Replace the Pallas kernels of deepxi_tpu/ops/kernels/spectral.py:
//   * stft_mag_forward -> stft_mag_pallas: hop rows x2d [B, T+1, N_s]
//     (N_d = 2 N_s) to magnitudes [B, T, nb], nb = K/2 + 1. Frame t is hop
//     rows t and t+1; its windowed real DFT is the product with the analysis
//     matrix M [N_d, 2 nb] (cos columns, then sin columns), and only
//     |X| = sqrt(re^2 + im^2) is written.
//   * enhance_frames_forward -> enhance_frames_pallas: Y [B, T, 2 nb] (re,
//     then im) times the gain G [B, T, nb] in both halves, times the
//     synthesis matrix S [2 nb, N_d] (inverse DFT with the COLA window folded
//     in): frames [B, T, N_d], overlap-added by the caller.
//
// The functions are bound by bytes: a frame moves 3 KB (|X|: a hop row in, a
// magnitude row out) or 5 KB (frames: spectrum, gain, frame), and an FFT
// needs ~12 KFLOP of it. The dense product these kernels keep, as the TPU
// kernels do, takes 2 * N_d * 2 nb = 526,336 FLOP a frame (N_d 512, nb 257):
// 100-170 FLOP a byte, so they are bound by operations, ~13x above the
// function's least time. The TPU kernels hold a 128-frame tile and the whole
// 1 MB matrix in VMEM and run one product on the matrix unit; a Hopper block
// has 227 KB, so here the matrix is walked in 32-deep chunks through shared
// memory, as a register-tiled f32 FMA product.
//
// Design (simple first): 256 threads a CTA, thread (tr, tc) = (tid / 16,
// tid % 16). stft_mag: a CTA takes 64 frames x 64 bins of one batch row. It
// stages its 65 hop rows once (frames never reach device memory: frame f's
// sample n is hop row f + n / N_s, column n % N_s), and per chunk of M the
// 64 cos and 64 sin columns of its bins. A thread accumulates 4 frames
// (tr + 16 i) x 4 bins (4 tc ..) of both re and im, so the magnitude is
// formed in registers. enhance_frames: a CTA takes 128 frames x 64 output
// samples; per chunk it stages the gained spectrum (Y * G as it is loaded,
// transposed) and 32 rows of S; a thread accumulates 8 frames x 4 samples.
// Columns past nb (514 and 257 are no multiple of a tile) and frames past T
// are zeros that are never stored.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // threads a CTA
constexpr int KC = 32;   // depth of a chunk
constexpr int TN = 64;   // bins (stft_mag) or output samples (frames) a CTA
constexpr int TM_MAG = 64;   // frames a CTA, stft_mag: 4 a thread
constexpr int TM_SYN = 128;  // frames a CTA, enhance_frames: 8 a thread

// Shared memory of stft_mag_kernel: (TM_MAG + 1) hop rows of N_s + 4
// floats (the pad puts the two frames a warp reads in other banks) and a
// cos and a sin chunk of KC x TN.
size_t mag_smem_bytes(int N_s) {
  return ((size_t)(TM_MAG + 1) * (N_s + 4) + 2 * KC * TN) * sizeof(float);
}

// CTA (bin tile blockIdx.x, frame tile blockIdx.y, batch row blockIdx.z).
__global__ void __launch_bounds__(NT)
stft_mag_kernel(const float* __restrict__ x2d, const float* __restrict__ M,
                float* __restrict__ out, int T, int N_s, int nb) {
  extern __shared__ float4 smem4[];
  const int ldx = N_s + 4;
  float* hop = reinterpret_cast<float*>(smem4);
  float* mre = hop + (TM_MAG + 1) * ldx;
  float* mim = mre + KC * TN;
  const int j0 = blockIdx.x * TN, t0 = blockIdx.y * TM_MAG, b = blockIdx.z;
  const int tid = threadIdx.x, tc = tid % 16, tr = tid / 16;
  const int N_d = 2 * N_s, ldm = 2 * nb;

  // hop rows t0 .. t0 + TM_MAG of this batch row; rows past T are zeros
  const float* xb = x2d + (size_t)b * (T + 1) * N_s;
  const int n4 = N_s / 4;
  for (int idx = tid; idx < (TM_MAG + 1) * n4; idx += NT) {
    const int r = idx / n4, c4 = idx % n4, t = t0 + r;
    reinterpret_cast<float4*>(hop + r * ldx)[c4] =
        t <= T ? __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * N_s) + c4)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) re[i][c] = im[i][c] = 0.f;

  for (int k0 = 0; k0 < N_d; k0 += KC) {
    __syncthreads();  // the hop rows are staged; the last chunk is consumed
    for (int idx = tid; idx < KC * TN; idx += NT) {
      const int j = j0 + idx % TN;
      const float* row = M + (size_t)(k0 + idx / TN) * ldm;
      mre[idx] = j < nb ? __ldg(row + j) : 0.f;
      mim[idx] = j < nb ? __ldg(row + nb + j) : 0.f;
    }
    __syncthreads();
    // the chunk lies in one half of the frames (KC divides N_s)
    const int half = k0 >= N_s;
    const float* a = hop + (tr + half) * ldx + (k0 - half * N_s);
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 wr = reinterpret_cast<const float4*>(mre + kk * TN)[tc];
      const float4 wi = reinterpret_cast<const float4*>(mim + kk * TN)[tc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = a[i * 16 * ldx + kk];
        re[i][0] = fmaf(v, wr.x, re[i][0]);
        re[i][1] = fmaf(v, wr.y, re[i][1]);
        re[i][2] = fmaf(v, wr.z, re[i][2]);
        re[i][3] = fmaf(v, wr.w, re[i][3]);
        im[i][0] = fmaf(v, wi.x, im[i][0]);
        im[i][1] = fmaf(v, wi.y, im[i][1]);
        im[i][2] = fmaf(v, wi.z, im[i][2]);
        im[i][3] = fmaf(v, wi.w, im[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tr + 16 * i;
    if (t >= T) continue;
    float* o = out + ((size_t)b * T + t) * nb;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + 4 * tc + c;
      if (j < nb) o[j] = sqrtf(re[i][c] * re[i][c] + im[i][c] * im[i][c]);
    }
  }
}

// CTA (sample tile blockIdx.x, frame tile blockIdx.y, batch row blockIdx.z).
__global__ void __launch_bounds__(NT)
enhance_frames_kernel(const float* __restrict__ Y, const float* __restrict__ G,
                      const float* __restrict__ S, float* __restrict__ out,
                      int T, int nb, int N_d) {
  __shared__ float ys[KC][TM_SYN + 1];  // gained spectrum chunk, transposed
  __shared__ __align__(16) float ss[KC][TN];
  const int n0 = blockIdx.x * TN, t0 = blockIdx.y * TM_SYN, b = blockIdx.z;
  const int tid = threadIdx.x, tc = tid % 16, tr = tid / 16;
  const int depth = 2 * nb;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < depth; k0 += KC) {
    __syncthreads();  // the last chunk is consumed
    // a warp loads 32 consecutive columns of one frame's spectrum and gain
    for (int idx = tid; idx < TM_SYN * KC; idx += NT) {
      const int f = idx / KC, kk = idx % KC, t = t0 + f, k = k0 + kk;
      float v = 0.f;
      if (t < T && k < depth) {
        const size_t row = (size_t)b * T + t;
        v = __ldg(Y + row * depth + k) * __ldg(G + row * nb + (k < nb ? k : k - nb));
      }
      ys[kk][f] = v;
    }
    for (int idx = tid; idx < KC * TN / 4; idx += NT) {
      const int kk = idx / (TN / 4), c4 = idx % (TN / 4), k = k0 + kk;
      reinterpret_cast<float4*>(ss[kk])[c4] =
          k < depth ? __ldg(reinterpret_cast<const float4*>(S + (size_t)k * N_d + n0) + c4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 w = reinterpret_cast<const float4*>(ss[kk])[tc];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = ys[kk][tr + 16 * i];
        acc[i][0] = fmaf(v, w.x, acc[i][0]);
        acc[i][1] = fmaf(v, w.y, acc[i][1]);
        acc[i][2] = fmaf(v, w.z, acc[i][2]);
        acc[i][3] = fmaf(v, w.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + tr + 16 * i;
    if (t < T)
      reinterpret_cast<float4*>(out + ((size_t)b * T + t) * N_d + n0)[tc] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

extern "C" {

const char* spectral_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out [B, T, nb] = |x2d framed @ M| for x2d [B, T+1, N_s] and M [2 N_s, 2 nb]
// (16-byte aligned, 32 | N_s). Returns 0 or the CUDA error of the launch.
int stft_mag_forward(const void* x2d, const void* M, void* out, int B, int T,
                     int N_s, int nb, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || nb < 1 || N_s < KC || N_s % KC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mag_smem_bytes(N_s);
  cudaError_t e = cudaFuncSetAttribute(
      stft_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nb + TN - 1) / TN, (T + TM_MAG - 1) / TM_MAG, B);
  stft_mag_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)x2d, (const float*)M, (float*)out, T, N_s, nb);
  return (int)cudaGetLastError();
}

// out [B, T, N_d] = (Y * [G || G]) @ S for Y [B, T, 2 nb], G [B, T, nb] and
// S [2 nb, N_d] (16-byte aligned, 64 | N_d). Returns 0 or the CUDA error of
// the launch.
int enhance_frames_forward(const void* Y, const void* G, const void* S,
                           void* out, int B, int T, int nb, int N_d,
                           void* stream) {
  if (B < 1 || B > 65535 || T < 1 || nb < 1 || N_d < TN || N_d % TN)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N_d / TN, (T + TM_SYN - 1) / TM_SYN, B);
  enhance_frames_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)Y, (const float*)G, (const float*)S, (float*)out, T, nb, N_d);
  return (int)cudaGetLastError();
}

}  // extern "C"
