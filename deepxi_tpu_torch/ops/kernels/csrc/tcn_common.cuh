// Shared pieces of the fused ResNetV2 kernels (tcn_fused.cu, the inference
// forward, and tcn_fused_train.cu, the training backward): widths, the packed
// weight layout, warp reductions, LayerNorm moments, and the tensor-core
// product with its weights staged in shared memory (the forward's units,
// and the backward's recompute and input gradients). float32 values
// throughout.
//
// A block is  h += W3 LN(relu(conv_d(LN(relu(W1 LN(relu(h)) + b1))) + b2)) + b3
// with W1 [C, DF], a causal dilated conv of KS taps [KS, DF, DF] and
// W3 [DF, C]; LN has eps 1e-6 and no affine. The conv's causal zero padding
// applies to its INPUT a2: rows of a2 before t = 0 are zero.
//
// The widths are compile-time constants given as defines (TCN_C = d_model,
// TCN_DF = d_f, TCN_KS = k); the wrappers build one library per set of
// widths (_build.py). They take C and DF multiples of 4 up to 1024 (16-byte
// staging) and KS >= 1; rows are any width, a warp lane taking elements
// lane + 32 e. The tensor-core product pads K and N to multiples of 8 (the
// m16n8k8 tile) with zeros in shared memory.

#pragma once

#include <cuda_runtime.h>

#include "mma_tf32x3.cuh"

namespace {

#if !defined(TCN_C) || !defined(TCN_DF) || !defined(TCN_KS)
#error "build with -DTCN_C=<d_model> -DTCN_DF=<d_f> -DTCN_KS=<k>"
#endif

constexpr int C = TCN_C;     // d_model
constexpr int DF = TCN_DF;   // d_f
constexpr int KS = TCN_KS;   // taps of the dilated conv
constexpr int NT = 256;      // threads per CTA
constexpr int LDH = C + 4;   // padded shared-memory row strides: rows that
constexpr int LDF = DF + 4;  // one warp reads at once fall in other banks
constexpr float EPS = 1e-6f;

// One block's packed weights (floats): w1 [C,DF], b1, w2 [KS,DF,DF], b2,
// w3 [DF,C], b3 -- the order of BlockWeights, flattened.
constexpr int OFF_W1 = 0;
constexpr int OFF_B1 = OFF_W1 + C * DF;
constexpr int OFF_W2 = OFF_B1 + DF;
constexpr int OFF_B2 = OFF_W2 + KS * DF * DF;
constexpr int OFF_W3 = OFF_B2 + DF;
constexpr int OFF_B3 = OFF_W3 + DF * C;
constexpr int BLOCK_FLOATS = OFF_B3 + C;
static_assert(C % 4 == 0 && DF % 4 == 0 && C <= 4 * NT && DF <= 4 * NT &&
                  KS >= 1,
              "C and DF multiples of 4 up to 1024, KS >= 1");
static_assert(OFF_B1 % 4 == 0 && OFF_W2 % 4 == 0 && OFF_B2 % 4 == 0 &&
              OFF_W3 % 4 == 0 && OFF_B3 % 4 == 0 && BLOCK_FLOATS % 4 == 0,
              "float4 loads need 16-byte aligned weight segments");

// Elements of a W-wide row a warp lane holds (lane + 32 e, e < per_lane(W)),
// and whether element e of `lane` lies in the row (always, when 32 | W).
__host__ __device__ constexpr int per_lane(int W) { return (W + 31) / 32; }
template <int W>
__device__ __forceinline__ bool in_row(int lane, int e) {
  return W % 32 == 0 || lane + 32 * e < W;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// relu(row) into v (the lane's elements, 0 past the row) and its mean and
// 1/sqrt(var+eps): two-pass as the reference computes them, or with
// ONE_PASS the variance as E[x^2] - E[x]^2 (no clip at 0), as the JAX pack2
// kernel's "matmul" mode.
template <int W, bool ONE_PASS = false>
__device__ __forceinline__ void relu_moments(const float* row, int lane,
                                             float (&v)[per_lane(W)],
                                             float& mu, float& rstd) {
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int e = 0; e < per_lane(W); ++e) {
    v[e] = in_row<W>(lane, e) ? fmaxf(row[lane + 32 * e], 0.f) : 0.f;
    s += v[e];
    if (ONE_PASS) q = fmaf(v[e], v[e], q);
  }
  mu = warp_sum(s) * (1.f / W);
  if (ONE_PASS) {
    rstd = rsqrtf(warp_sum(q) * (1.f / W) - mu * mu + EPS);
    return;
  }
  q = 0.f;
#pragma unroll
  for (int e = 0; e < per_lane(W); ++e) {
    const float t = in_row<W>(lane, e) ? v[e] - mu : 0.f;
    q += t * t;
  }
  rstd = rsqrtf(warp_sum(q) * (1.f / W) + EPS);
}

// st[2r] = -mu*rstd, st[2r+1] = rstd of relu(h[r]) for rows [r0, r1).
__device__ void h_moments(const float* h, float* st, int r0, int r1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = r0 + warp; r < r1; r += NT / 32) {
    float v[per_lane(C)], mu, rstd;
    relu_moments<C>(h + r * LDH, lane, v, mu, rstd);
    if (lane == 0) {
      st[2 * r] = -mu * rstd;
      st[2 * r + 1] = rstd;
    }
  }
}

// x[r] <- LN(relu(x[r])) in place for rows [r0, r1) of a DF-wide buffer;
// rows below zero_below (before t = 0) become zero.
template <bool ONE_PASS = false>
__device__ void relu_ln_inplace(float* x, int r0, int r1, int zero_below) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = r0 + warp; r < r1; r += NT / 32) {
    float* row = x + r * LDF;
    float v[per_lane(DF)], mu, rstd;
    relu_moments<DF, ONE_PASS>(row, lane, v, mu, rstd);
    const bool pre = r < zero_below;
#pragma unroll
    for (int e = 0; e < per_lane(DF); ++e)
      if (in_row<DF>(lane, e)) row[lane + 32 * e] = pre ? 0.f : (v[e] - mu) * rstd;
  }
}

// -- the forward's tensor-core product -----------------------------------
//
// K and N padded to the m16n8k8 tile; a unit's weights in shared memory as
// [TAPS * KP, w_ld(N)] rows, their stride 8 mod 32 so that a B fragment's
// lanes (rows t, columns g) fall in distinct banks; padding zero.
__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr int w_ld(int n) {
  return pad8(n) + (40 - pad8(n) % 32) % 32;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int CP = pad8(C), DFP = pad8(DF);
static_assert(LDH >= CP && LDF >= DFP, "window rows hold the padded widths");
// floats of the weight buffer: the largest unit, W1, the conv or W3
constexpr int WBUF_FLOATS =
    (cmax(cmax(CP * w_ld(DF), KS * DFP * w_ld(DF)), DFP * w_ld(C)) + 3) & ~3;

// Stage one unit's weights W [TAPS, KD, N] (row-major, global) into wbuf
// with cp.async, and commit them as one group; padding rows and columns are
// written as zeros.
template <int KD, int N, int TAPS>
__device__ void stage_weights(float* wbuf, const float* __restrict__ W) {
  constexpr int KP = pad8(KD), LDW = w_ld(N), C4 = pad8(N) / 4;
  for (int idx = threadIdx.x; idx < TAPS * KP * C4; idx += NT) {
    const int row = idx / C4, c4 = idx % C4;
    const int j = row / KP, k = row % KP;
    float* dst = wbuf + row * LDW + 4 * c4;
    if (k < KD && 4 * c4 < N)
      cp_async16(dst, W + ((size_t)j * KD + k) * N + 4 * c4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
}

// Stage a unit's weights when the kernel keeps them in shared memory
// (W_SMEM), else commit an empty group, so the waits count the same.
template <bool W_SMEM, int KD, int N, int TAPS>
__device__ __forceinline__ void stage_unit(float* wbuf, const float* W) {
  if constexpr (W_SMEM)
    stage_weights<KD, N, TAPS>(wbuf, W);
  else
    cp_async_commit();
}

// For rows r in [r0, r1) of NB windows (bs floats apart in A, st and out):
//   out[r] (= or +=) [bias] + sum_j A'[r - (TAPS-1-j) d] @ W[j]
// with W staged in shared memory by stage_weights<KD, N, TAPS> (W_SMEM),
// or W [TAPS, KD, N] in global memory, read through L1/L2 (weights too wide
// to stage beside a window), and A' the shared-memory rows of A, or
// LN(relu(A)) from the moments st when LN_IN. A negative d reads rows
// after r (the input gradient of a causal conv).
// The work is cut into items of MS slabs of 16 rows by NCB n-blocks of 8
// columns, dealt to the warps in turn; a warp's lane (g, t) holds rows g
// and g + 8 of each slab. Each B fragment, split once, feeds the MS slabs
// of the NB windows. The products are f32-accurate (mma_tf32x3.cuh): KG
// k-steps are summed on the tensor cores, then added to the running sum in
// f32. Rows of the last slab past r1 repeat row r1 - 1 and are not stored.
template <int KD, int N, int TAPS, bool LN_IN, bool ACCUM, int NB, int MS,
          bool W_SMEM, bool BIAS = true>
__device__ void mma_product(const float* A, int lda, const float* st,
                            const float* W, const float* __restrict__ bias,
                            int d, float* out, int ldo, int r0, int r1,
                            int bs = 0) {
  constexpr int ITEM_NB = 4;  // n-blocks of 8 columns an item
  constexpr int KG = 2;       // k-steps summed on the tensor cores a time
  constexpr int KP = pad8(KD), NBLK = pad8(N) / 8;
  constexpr int LDW = W_SMEM ? w_ld(N) : N, KROWS = W_SMEM ? KP : KD;
  constexpr int NCB = NBLK < ITEM_NB ? NBLK : ITEM_NB;
  constexpr int NCH = (NBLK + NCB - 1) / NCB;
  // B element (k, col) of tap Wj; zero past the weights in global memory
  auto w_at = [](const float* Wj, int k, int col) -> float {
    if (W_SMEM) return Wj[k * LDW + col];
    return (KD % 8 == 0 || k < KD) && (N % 8 == 0 || col < N)
               ? __ldg(Wj + k * LDW + col) : 0.f;
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int items = (r1 - r0 + 16 * MS - 1) / (16 * MS) * NCH;
  for (int item = warp; item < items; item += NT / 32) {
    const int rbase = r0 + item / NCH * 16 * MS, ch = item % NCH;
    int row[MS][2];
#pragma unroll
    for (int m = 0; m < MS; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) row[m][i] = min(rbase + 16 * m + g + 8 * i, r1 - 1);
    float acc[NB][MS][NCB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int m = 0; m < MS; ++m) zero(acc[n][m]);
#pragma unroll 1
    for (int j = 0; j < TAPS; ++j) {
      const int shift = (j - (TAPS - 1)) * d;
      const float* Ar[NB][MS][2];
      float sh[NB][MS][2], sc[NB][MS][2];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int m = 0; m < MS; ++m)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = row[m][i] + shift;
            Ar[n][m][i] = A + n * bs + r * lda;
            if (LN_IN) {
              sh[n][m][i] = st[n * bs + 2 * r];
              sc[n][m][i] = st[n * bs + 2 * r + 1];
            }
          }
      const float* Wj = W + j * KROWS * LDW;
#pragma unroll 1
      for (int kg0 = 0; kg0 < KP; kg0 += 8 * KG) {
        float p[NB][MS][NCB][4];
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int m = 0; m < MS; ++m) zero(p[n][m]);
#pragma unroll
        for (int k0 = kg0; k0 < kg0 + 8 * KG; k0 += 8) {
          if (KP % (8 * KG) != 0 && k0 >= KP) break;
          const int k = k0 + t;
          // n-blocks past the last (N / 8 not a multiple of NCB) multiply
          // zeros and are not stored
          FragB b[NCB];
#pragma unroll
          for (int nb = 0; nb < NCB; ++nb) {
            const int col = (ch * NCB + nb) * 8 + g;
            const bool in = NBLK % NCB == 0 || ch * NCB + nb < NBLK;
            set_b(b[nb], in ? w_at(Wj, k, col) : 0.f, in ? w_at(Wj, k + 4, col) : 0.f);
          }
#pragma unroll
          for (int n = 0; n < NB; ++n)
#pragma unroll
            for (int m = 0; m < MS; ++m) {
              float e[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int i = u & 1, kk = k + 4 * (u >> 1);
                float a = Ar[n][m][i][kk];
                if (LN_IN) a = fmaf(fmaxf(a, 0.f), sc[n][m][i], sh[n][m][i]);
                e[u] = KD % 8 == 0 || kk < KD ? a : 0.f;
              }
              FragA fa;
              set_a(fa, e[0], e[1], e[2], e[3]);
              mma_tf32x3(p[n][m], fa, b);
            }
        }
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int m = 0; m < MS; ++m) add_to(acc[n][m], p[n][m]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < NCB; ++nb) {
      const int col = (ch * NCB + nb) * 8 + 2 * t;
      if (col >= N) continue;  // N % 4 == 0: col + 1 < N too
      const float2 bb = BIAS ? __ldg(reinterpret_cast<const float2*>(bias + col))
                             : make_float2(0.f, 0.f);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int m = 0; m < MS; ++m)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = rbase + 16 * m + g + 8 * i;
            if (r >= r1) continue;
            float2* o = reinterpret_cast<float2*>(out + n * bs + r * ldo + col);
            float2 v = ACCUM ? *o : make_float2(0.f, 0.f);
            v.x += acc[n][m][nb][2 * i] + bb.x;
            v.y += acc[n][m][nb][2 * i + 1] + bb.y;
            *o = v;
          }
    }
  }
}

}  // namespace
