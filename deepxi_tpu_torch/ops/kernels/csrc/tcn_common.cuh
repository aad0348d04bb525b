// Shared pieces of the fused ResNetV2 kernels (tcn_fused.cu, the inference
// forward, and tcn_fused_train.cu, the training backward): widths, the packed
// weight layout, warp reductions, LayerNorm moments and the register-tiled
// FMA product. float32 throughout.
//
// A block is  h += W3 LN(relu(conv_d(LN(relu(W1 LN(relu(h)) + b1))) + b2)) + b3
// with W1 [C, DF], a causal dilated conv of KS taps [KS, DF, DF] and
// W3 [DF, C]; LN has eps 1e-6 and no affine. The conv's causal zero padding
// applies to its INPUT a2: rows of a2 before t = 0 are zero.
//
// The widths are compile-time constants given as defines (TCN_C = d_model,
// TCN_DF = d_f, TCN_KS = k); the wrappers build one library per set of
// widths (_build.py). They take C and DF multiples of 4 up to 1024 (a
// product thread owns 4 output columns, and N / 4 of them span a row) and
// KS >= 1; rows are any width, a warp lane taking elements lane + 32 e.

#pragma once

#include <cuda_runtime.h>

namespace {

#if !defined(TCN_C) || !defined(TCN_DF) || !defined(TCN_KS)
#error "build with -DTCN_C=<d_model> -DTCN_DF=<d_f> -DTCN_KS=<k>"
#endif

constexpr int C = TCN_C;     // d_model
constexpr int DF = TCN_DF;   // d_f
constexpr int KS = TCN_KS;   // taps of the dilated conv
constexpr int NT = 256;      // threads per CTA
constexpr int RM = 4;        // rows per thread in a product
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

// For rows r in [r0, r1):
//   out[r] (= or +=) [bias] + sum_j A'[r - (TAPS-1-j) d] @ W[j]
// with W[j] a [KD, N] row-major slice in global memory and A' the
// shared-memory rows of A, or LN(relu(A)) from the moments st when LN_IN.
// A negative d reads rows after r (the input gradient of a causal conv).
// Thread (tr, tc) owns columns 4tc..4tc+3 of rows base+tr+i*TR, i < RM;
// when N / 4 does not divide NT, the threads past TR * TN rows idle.
// With NB > 1 the same rows of NB batch rows' windows, bs floats apart in
// A, st and out alike, share each weight load.
template <int KD, int N, int TAPS, bool LN_IN, bool ACCUM, bool BIAS = true,
          int NB = 1>
__device__ void unit_product(const float* A, int lda, const float* st,
                             const float* __restrict__ W,
                             const float* __restrict__ bias, int d,
                             float* out, int ldo, int r0, int r1, int bs = 0) {
  constexpr int TN = N / 4;
  constexpr int TR = NT / TN;
  constexpr int ROWS = TR * RM;
  const int tc = threadIdx.x % TN, tr = threadIdx.x / TN;
  if (NT % TN != 0 && tr >= TR) return;
  const float4 b = BIAS ? __ldg(reinterpret_cast<const float4*>(bias) + tc)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = r0; base < r1; base += ROWS) {
    float acc[NB][RM][4];
    int rows[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      // rows past r1 repeat the last row and are not stored
      rows[i] = min(base + tr + i * TR, r1 - 1);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][i][c] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const int shift = (j - (TAPS - 1)) * d;
      const float* Ar[RM];
      float sh[NB][RM], sc[NB][RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = rows[i] + shift;
        Ar[i] = A + r * lda;
        if (LN_IN) {
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            sh[n][i] = st[n * bs + 2 * r];
            sc[n][i] = st[n * bs + 2 * r + 1];
          }
        }
      }
      const float4* Wj = reinterpret_cast<const float4*>(W + j * KD * N) + tc;
#pragma unroll 4
      for (int q = 0; q < KD; ++q) {
        const float4 w = __ldg(Wj + q * TN);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            float a = Ar[i][n * bs + q];
            if (LN_IN) a = fmaf(fmaxf(a, 0.f), sc[n][i], sh[n][i]);
            acc[n][i][0] = fmaf(a, w.x, acc[n][i][0]);
            acc[n][i][1] = fmaf(a, w.y, acc[n][i][1]);
            acc[n][i][2] = fmaf(a, w.z, acc[n][i][2]);
            acc[n][i][3] = fmaf(a, w.w, acc[n][i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = base + tr + i * TR;
        if (r < r1) {
          float4* o = reinterpret_cast<float4*>(out + n * bs + r * ldo) + tc;
          float4 v = ACCUM ? *o : make_float4(0.f, 0.f, 0.f, 0.f);
          v.x += acc[n][i][0] + b.x;
          v.y += acc[n][i][1] + b.y;
          v.z += acc[n][i][2] + b.z;
          v.w += acc[n][i][3] + b.w;
          *o = v;
        }
      }
    }
  }
}

}  // namespace
