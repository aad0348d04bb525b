// Backward of the fused ResNetV2 bottleneck blocks for Hopper (sm_90a),
// float32 throughout.
//
// Replaces the Pallas kernel deepxi_tpu/ops/kernels/tcn_fused_train.py
// fused_block_group_bwd: the reverse walk over a group of blocks giving dh and
// every weight gradient summed over the batch. (Its saving forward,
// fused_block_group_whole_saved, launches tcn_block_forward of tcn_fused.cu
// once per block into a [G, B, T, 256] buffer.)
//
// The Pallas kernel keeps the group's block inputs [G, T, 256] in VMEM
// (6.5 MB at G 10, T 640) and carries the weight gradients in VMEM across a
// grid that runs in order. A Hopper CTA has 227 KB and CTAs run in parallel,
// so tcn_group_backward (one host call a group) walks the blocks in reverse,
// ONE block at a time, reading its input h from device memory, in three
// launches a block:
//   1. tcn_bwd_act_kernel, one CTA per (time tile, batch row): recomputes
//      a = LN(relu(h)), u1, a2 (over the tile plus the 2d rows before it that
//      the dilated conv reads; pre-sequence rows of a2 zero) and y with the
//      forward's own product (tcn_common.cuh's mma_product, the same k-step
//      grouping and the same bias add), so u1 and y, and the ReLU masks
//      read from them, are bitwise the forward's; then da3 = dout W3^T and
//      dy = LN'(da3) * (y > 0). Writes u1, a2, a3, dy and the moments of
//      relu(h) for the tile rows to a scratch of [B*T, DF] buffers.
//   2. tcn_bwd_input_kernel, one CTA per (time tile, batch row): the conv's
//      input gradient reaches FORWARD, da2[t] = sum_j dy[t + (k-1-j) d] W2[j]^T,
//      so the CTA reads dy over the tile and the 2d rows after it (zero past
//      T); then du1 = LN'(da2) * (u1 > 0), da = du1 W1^T and
//      dh = dout + LN'(da) * (h > 0).
//   3. tcn_bwd_wgrad_kernel: dW1 = a^T du1, dW2[j] = a2(shifted by (k-1-j) d)^T dy,
//      dW3 = a3^T dout and the bias sums, as products contracting over the
//      B*T rows: output tiles of up to 64 x 64 (11 at C 256, DF 64, k 3),
//      each over a fixed slice (split) of the rows; every split writes its
//      own partial tile, and the last split of a tile to finish (a counter
//      per tile) sums the splits in the fixed order 0, 1, ... No atomics on
//      the values: the weight gradients are bitwise the same from run to run.
// Every product runs on the tensor cores, m16n8k8 TF32 mma.sync with
// operands split hi/lo to f32 accuracy (mma_tf32x3.cuh), two k-steps summed
// on the tensor cores and added in f32: the recompute and the input
// gradients through mma_product with the unit's weights staged in shared
// memory by cp.async (the input gradients read the transposed weights the
// wrapper packs: w1t [DF, C], w2t[j] = W2[j]^T, w3t [C, DF]); the weight
// gradients with the transposed activation tile as the A operand, 32 rows
// a stage, the next stage's loads in flight in registers.
//
// The widths are tcn_common.cuh's build defines.
//
// What bounds it on this card (resnet-1.1c's widths, C 256, DF 64, k 3): per
// row and block the backward computes the recompute's two products (57,344
// FLOP), the input gradients (90,112) and the weight gradients (90,112),
// 237,568 FLOP against ~4 KB of activations and gradients moved, so it is
// bound by operations: 4.9 GFLOP for 10 blocks at B 8, T 256, 0.030 ms at
// the 165 TFLOP/s of f32-accurate tensor-core products (three dense TF32
// products, 495 TFLOP/s, for one).

#include "deepxi_error.cuh"
#include "tcn_common.cuh"

namespace {

// One block's transposed weights (floats): w1t [DF, C], w2t [KS, DF, DF] with
// w2t[j] = W2[j]^T, w3t [C, DF].
constexpr int OFFT_W1T = 0;
constexpr int OFFT_W2T = OFFT_W1T + DF * C;
constexpr int OFFT_W3T = OFFT_W2T + KS * DF * DF;
constexpr int BLOCK_T_FLOATS = OFFT_W3T + C * DF;

// shared-memory floats per window row of the first kernel: h (later dout),
// a2, y, da3, moments
constexpr int ACT_ROW_FLOATS = LDH + 3 * LDF + 2;
// A unit's weights go to shared memory when a 32-row window still fits
// beside them (the flagship's: 74 KB and 85 rows); wider ones are read
// from global memory through L1/L2 (a build define, not a run-time choice).
constexpr bool W_SMEM =
    ((size_t)WBUF_FLOATS + 32 * (size_t)ACT_ROW_FLOATS) * sizeof(float) <= 232448;
constexpr int SMEM_W_FLOATS = W_SMEM ? WBUF_FLOATS : 0;

constexpr int WG_RC = 64;    // rows of a weight-gradient stage
constexpr int MAX_SPLITS = 16;  // row splits of the weight gradients, at most
constexpr int WT = 64;       // edge of a weight-gradient tile
constexpr int LDT = WT + 8;  // its shared-memory row stride, 8 mod 32
constexpr int TI_C = (C + WT - 1) / WT, TI_F = (DF + WT - 1) / WT;
// tiles of dW1 [C, DF], of the KS taps of dW2 [DF, DF] and of dW3 [DF, C]
constexpr int WG_TILES = TI_C * TI_F + KS * TI_F * TI_F + TI_F * TI_C;

// LN'(u; z) * mask over one DF-wide row by one warp: z is the LN input
// relu(v) of pre-activation v, u the gradient w.r.t. LN's output; returns
// in `out` rstd (u - mean u - zhat mean(u zhat)) where v > 0, else 0.
// Also gives zhat = LN(z).
__device__ __forceinline__ void ln_bwd_row(const float* v_row, const float* u_row,
                                           int lane, float (&zh)[per_lane(DF)],
                                           float (&out)[per_lane(DF)]) {
  float z[per_lane(DF)], mu, rstd;
  relu_moments<DF>(v_row, lane, z, mu, rstd);
  float u[per_lane(DF)], su = 0.f, suz = 0.f;
#pragma unroll
  for (int e = 0; e < per_lane(DF); ++e) {
    const bool in = in_row<DF>(lane, e);
    zh[e] = in ? (z[e] - mu) * rstd : 0.f;
    u[e] = in ? u_row[lane + 32 * e] : 0.f;
    su += u[e];
    suz += u[e] * zh[e];
  }
  su = warp_sum(su) * (1.f / DF);
  suz = warp_sum(suz) * (1.f / DF);
#pragma unroll
  for (int e = 0; e < per_lane(DF); ++e)
    out[e] = z[e] > 0.f ? rstd * (u[e] - su - zh[e] * suz) : 0.f;
}

__global__ void __launch_bounds__(NT, 1)
tcn_bwd_act_kernel(const float* __restrict__ h, const float* __restrict__ dout,
                   const float* __restrict__ w, const float* __restrict__ wt,
                   int d, int T, int tile, float* __restrict__ u1s,
                   float* __restrict__ a2s, float* __restrict__ a3s,
                   float* __restrict__ dys, float* __restrict__ hst) {
  extern __shared__ float4 smem4[];
  const int halo = (KS - 1) * d;
  const int R = tile + halo;
  float* wbuf = reinterpret_cast<float*>(smem4);
  float* hw = wbuf + SMEM_W_FLOATS;
  float* a2 = hw + R * LDH;
  float* yb = a2 + R * LDF;
  float* db = yb + R * LDF;
  float* st = db + R * LDF;

  const int t0 = blockIdx.x * tile;
  const int first = t0 - halo;  // time of window row 0
  const int nrows = halo + min(tile, T - t0);
  const int pre_rows = max(0, -first);
  const size_t row0 = (size_t)blockIdx.y * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < nrows * (C / 4); idx += NT) {
    const int r = idx / (C / 4), c4 = idx % (C / 4);
    const int t = first + r;
    cp_async16(hw + r * LDH + 4 * c4, t >= 0 ? h + (row0 + t) * C + 4 * c4 : h, t < 0);
  }
  cp_async_commit();
  stage_unit<W_SMEM, C, DF, 1>(wbuf, w + OFF_W1);
  cp_async_wait<1>();
  __syncthreads();
  h_moments(hw, st, 0, nrows);
  cp_async_wait<0>();
  __syncthreads();
  // u1 = a W1 + b1, as the forward computes it
  mma_product<C, DF, 1, true, false, 1, 1, W_SMEM>(
      hw, LDH, st, W_SMEM ? wbuf : w + OFF_W1, w + OFF_B1, 0, a2, LDF, 0, nrows);
  __syncthreads();
  stage_unit<W_SMEM, DF, DF, KS>(wbuf, w + OFF_W2);
  // u1 and the moments of relu(h) on the tile rows, for the next kernels;
  // dout replaces h on the tile rows (h is not read again)
  for (int idx = threadIdx.x; idx < (nrows - halo) * (DF / 4); idx += NT) {
    const int r = halo + idx / (DF / 4), c4 = idx % (DF / 4);
    reinterpret_cast<float4*>(u1s + (row0 + (first + r)) * DF)[c4] =
        reinterpret_cast<const float4*>(a2 + r * LDF)[c4];
  }
  for (int r = halo + threadIdx.x; r < nrows; r += NT) {
    const size_t gr = row0 + (first + r);
    hst[2 * gr] = st[2 * r];
    hst[2 * gr + 1] = st[2 * r + 1];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < (nrows - halo) * (C / 4); idx += NT) {
    const int r = halo + idx / (C / 4), c4 = idx % (C / 4);
    cp_async16(hw + r * LDH + 4 * c4, dout + (row0 + (first + r)) * C + 4 * c4);
  }
  cp_async_commit();
  relu_ln_inplace(a2, 0, nrows, pre_rows);
  cp_async_wait<0>();
  __syncthreads();
  for (int idx = threadIdx.x; idx < (nrows - halo) * (DF / 4); idx += NT) {
    const int r = halo + idx / (DF / 4), c4 = idx % (DF / 4);
    reinterpret_cast<float4*>(a2s + (row0 + (first + r)) * DF)[c4] =
        reinterpret_cast<const float4*>(a2 + r * LDF)[c4];
  }
  // y = conv(a2) + b2 on the tile rows, as the forward computes it
  mma_product<DF, DF, KS, false, false, 1, 1, W_SMEM>(
      a2, LDF, nullptr, W_SMEM ? wbuf : w + OFF_W2, w + OFF_B2, d, yb, LDF, halo,
      nrows);
  __syncthreads();
  stage_unit<W_SMEM, C, DF, 1>(wbuf, wt + OFFT_W3T);
  cp_async_wait<0>();
  __syncthreads();
  // da3 = dout W3^T on the tile rows
  mma_product<C, DF, 1, false, false, 1, 1, W_SMEM, false>(
      hw, LDH, nullptr, W_SMEM ? wbuf : wt + OFFT_W3T, nullptr, 0, db, LDF, halo,
      nrows);
  __syncthreads();
  // a3 = LN(relu(y)), dy = LN'(da3; relu(y)) * (y > 0)
  for (int r = halo + warp; r < nrows; r += NT / 32) {
    float zh[per_lane(DF)], g[per_lane(DF)];
    ln_bwd_row(yb + r * LDF, db + r * LDF, lane, zh, g);
    const size_t gr = row0 + (first + r);
#pragma unroll
    for (int e = 0; e < per_lane(DF); ++e) {
      if (!in_row<DF>(lane, e)) continue;
      a3s[gr * DF + lane + 32 * e] = zh[e];
      dys[gr * DF + lane + 32 * e] = g[e];
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
tcn_bwd_input_kernel(const float* __restrict__ h,
                     const float* __restrict__ dout,
                     const float* __restrict__ wt,
                     const float* __restrict__ u1s,
                     const float* __restrict__ dys,
                     const float* __restrict__ hst, int d, int T, int tile,
                     float* __restrict__ du1s, float* __restrict__ dh) {
  extern __shared__ float4 smem4[];
  const int halo = (KS - 1) * d;
  float* wbuf = reinterpret_cast<float*>(smem4);
  float* dyw = wbuf + SMEM_W_FLOATS;       // rows t0 .. t0+tile+halo-1
  float* g2 = dyw + (tile + halo) * LDF;   // da2, then du1
  float* ga = g2 + tile * LDF;             // da

  const int t0 = blockIdx.x * tile;
  const int n = min(tile, T - t0);
  const size_t row0 = (size_t)blockIdx.y * T + t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < (n + halo) * (DF / 4); idx += NT) {
    const int r = idx / (DF / 4), c4 = idx % (DF / 4);
    const bool in = t0 + r < T;
    cp_async16(dyw + r * LDF + 4 * c4, in ? dys + (row0 + r) * DF + 4 * c4 : dys, !in);
  }
  cp_async_commit();
  stage_unit<W_SMEM, DF, DF, KS>(wbuf, wt + OFFT_W2T);
  cp_async_wait<0>();
  __syncthreads();
  // da2[r] = sum_j dy[r + (KS-1-j) d] W2[j]^T: a negative dilation reads ahead
  mma_product<DF, DF, KS, false, false, 1, 1, W_SMEM, false>(
      dyw, LDF, nullptr, W_SMEM ? wbuf : wt + OFFT_W2T, nullptr, -d, g2, LDF, 0, n);
  __syncthreads();
  stage_unit<W_SMEM, DF, C, 1>(wbuf, wt + OFFT_W1T);
  // du1 = LN'(da2; relu(u1)) * (u1 > 0)
  for (int r = warp; r < n; r += NT / 32) {
    float zh[per_lane(DF)], g[per_lane(DF)];
    ln_bwd_row(u1s + (row0 + r) * DF, g2 + r * LDF, lane, zh, g);
#pragma unroll
    for (int e = 0; e < per_lane(DF); ++e) {
      if (!in_row<DF>(lane, e)) continue;
      g2[r * LDF + lane + 32 * e] = g[e];
      du1s[(row0 + r) * DF + lane + 32 * e] = g[e];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // da = du1 W1^T
  mma_product<DF, C, 1, false, false, 1, 1, W_SMEM, false>(
      g2, LDF, nullptr, W_SMEM ? wbuf : wt + OFFT_W1T, nullptr, 0, ga, LDH, 0, n);
  __syncthreads();
  // dh = dout + LN'(da; relu(h)) * (h > 0), with the forward's moments
  for (int r = warp; r < n; r += NT / 32) {
    const size_t gr = row0 + r;
    const float sh = hst[2 * gr], sc = hst[2 * gr + 1];
    float hv[per_lane(C)], zh[per_lane(C)], u[per_lane(C)], su = 0.f, suz = 0.f;
#pragma unroll
    for (int e = 0; e < per_lane(C); ++e) {
      const bool in = in_row<C>(lane, e);
      hv[e] = in ? h[gr * C + lane + 32 * e] : 0.f;
      zh[e] = in ? fmaf(fmaxf(hv[e], 0.f), sc, sh) : 0.f;
      u[e] = in ? ga[r * LDH + lane + 32 * e] : 0.f;
      su += u[e];
      suz += u[e] * zh[e];
    }
    su = warp_sum(su) * (1.f / C);
    suz = warp_sum(suz) * (1.f / C);
#pragma unroll
    for (int e = 0; e < per_lane(C); ++e) {
      if (!in_row<C>(lane, e)) continue;
      const size_t o = gr * C + lane + 32 * e;
      dh[o] = dout[o] + (hv[e] > 0.f ? sc * (u[e] - su - zh[e] * suz) : 0.f);
    }
  }
}

// blockIdx.x: output tile, the TI_C x TI_F tiles of dW1, then TI_F x TI_F
// for each tap of dW2, then TI_F x TI_C of dW3, each up to 64 x 64;
// blockIdx.y: split of the N = B*T rows. Writes the split's partial tile
// into part[split] (the packed block layout); the tile's last split to
// finish sums part[0], part[1], ... into dw and resets the tile's counter.
// The product: A = the activation tile transposed (feature by row), B =
// the gradient tile (row by feature), 64 rows a stage; warp w takes the
// output rows 16 (w % 4).. and the n-blocks 4 (w / 4).. of the tile.
__global__ void __launch_bounds__(NT)
tcn_bwd_wgrad_kernel(const float* __restrict__ h,
                     const float* __restrict__ hst,
                     const float* __restrict__ a2s,
                     const float* __restrict__ a3s,
                     const float* __restrict__ dys,
                     const float* __restrict__ du1s,
                     const float* __restrict__ dout, int d, int T, int N,
                     float* __restrict__ part, int* __restrict__ counters,
                     float* __restrict__ dw) {
  __shared__ __align__(16) float As[WG_RC][LDT];
  __shared__ __align__(16) float Ds[WG_RC][LDT];
  __shared__ int last;
  const int split = blockIdx.y;
  int tile = blockIdx.x, job, tap = 0, i0, j0, wa, wd;
  if (tile < TI_C * TI_F) {
    job = 0;  // dW1 = a^T du1
    i0 = WT * (tile / TI_F);
    j0 = WT * (tile % TI_F);
    wa = C - i0;
    wd = DF - j0;
  } else if ((tile -= TI_C * TI_F) < KS * TI_F * TI_F) {
    job = 1;  // dW2[tap] = a2(t - (KS-1-tap) d)^T dy
    tap = tile / (TI_F * TI_F);
    i0 = WT * (tile % (TI_F * TI_F) / TI_F);
    j0 = WT * (tile % TI_F);
    wa = DF - i0;
    wd = DF - j0;
  } else {
    tile -= KS * TI_F * TI_F;
    job = 2;  // dW3 = a3^T dout
    i0 = WT * (tile / TI_C);
    j0 = WT * (tile % TI_C);
    wa = DF - i0;
    wd = C - j0;
  }
  wa = min(wa, WT);
  wd = min(wd, WT);
  const int shift = (KS - 1 - tap) * d;
  const bool bias = i0 == 0 && (job != 1 || tap == 0);
  const int r_begin = (int)((long long)N * split / gridDim.y);
  const int r_end = (int)((long long)N * (split + 1) / gridDim.y);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp & 3), nb0 = 4 * (warp >> 2);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // a thread's FU float4 of the A rows and FU of the gradient rows of the
  // stage at rc
  constexpr int FU = WG_RC * WT / 4 / NT;
  auto fetch = [&](int rc, float4 (&av)[FU], float4 (&gv)[FU]) {
#pragma unroll
    for (int u = 0; u < FU; ++u) {
      const int idx = threadIdx.x + NT * u;
      const int rr = idx / (WT / 4), c4 = idx % (WT / 4);
      const int r = rc + rr;
      const bool ain = 4 * c4 < wa, din = 4 * c4 < wd;
      float4 a = zero4, gg = zero4;
      if (r < r_end) {
        if (job == 0) {
          if (ain) {
            const float4 hv = __ldg(
                reinterpret_cast<const float4*>(h + (size_t)r * C + i0) + c4);
            const float sh = hst[2 * (size_t)r], sc = hst[2 * (size_t)r + 1];
            a = make_float4(fmaf(fmaxf(hv.x, 0.f), sc, sh),
                            fmaf(fmaxf(hv.y, 0.f), sc, sh),
                            fmaf(fmaxf(hv.z, 0.f), sc, sh),
                            fmaf(fmaxf(hv.w, 0.f), sc, sh));
          }
          if (din)
            gg = __ldg(reinterpret_cast<const float4*>(du1s + (size_t)r * DF + j0) + c4);
        } else if (job == 1) {
          if (ain && r % T >= shift)
            a = __ldg(reinterpret_cast<const float4*>(a2s + (size_t)(r - shift) * DF + i0) +
                      c4);
          if (din)
            gg = __ldg(reinterpret_cast<const float4*>(dys + (size_t)r * DF + j0) + c4);
        } else {
          if (ain)
            a = __ldg(reinterpret_cast<const float4*>(a3s + (size_t)r * DF + i0) + c4);
          if (din)
            gg = __ldg(reinterpret_cast<const float4*>(dout + (size_t)r * C + j0) + c4);
        }
      }
      av[u] = a;
      gv[u] = gg;
    }
  };

  float acc[4][4];
  zero(acc);
  float bacc = 0.f;
  float4 na[FU], ng[FU];
  fetch(r_begin, na, ng);
  for (int rc = r_begin; rc < r_end; rc += WG_RC) {
#pragma unroll
    for (int u = 0; u < FU; ++u) {
      const int idx = threadIdx.x + NT * u;
      const int rr = idx / (WT / 4), c4 = idx % (WT / 4);
      *reinterpret_cast<float4*>(&As[rr][4 * c4]) = na[u];
      *reinterpret_cast<float4*>(&Ds[rr][4 * c4]) = ng[u];
    }
    __syncthreads();
    if (rc + WG_RC < r_end) fetch(rc + WG_RC, na, ng);
    // k-steps of 8 rows, two summed on the tensor cores at a time
#pragma unroll
    for (int s0 = 0; s0 < WG_RC / 8; s0 += 2) {
      float p[4][4];
      zero(p);
#pragma unroll
      for (int s = s0; s < s0 + 2; ++s) {
        const int k = 8 * s;
        FragA fa;
        set_a(fa, As[k + t][m0 + g], As[k + t][m0 + g + 8], As[k + t + 4][m0 + g],
              As[k + t + 4][m0 + g + 8]);
        FragB b[4];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          set_b(b[nb], Ds[k + t][8 * (nb0 + nb) + g], Ds[k + t + 4][8 * (nb0 + nb) + g]);
        mma_tf32x3(p, fa, b);
      }
      add_to(acc, p);
    }
    if (bias && threadIdx.x < wd) {  // four sums of a quarter, then in order
      float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < WG_RC; ++rr) q[rr % 4] += Ds[rr][threadIdx.x];
      bacc += (q[0] + q[1]) + (q[2] + q[3]);
    }
    __syncthreads();
  }

  size_t woff, boff = 0;
  int ldw;
  if (job == 0) {
    woff = OFF_W1 + i0 * DF + j0;
    ldw = DF;
    boff = OFF_B1;
  } else if (job == 1) {
    woff = OFF_W2 + tap * DF * DF + i0 * DF + j0;
    ldw = DF;
    boff = OFF_B2;
  } else {
    woff = OFF_W3 + i0 * C + j0;
    ldw = C;
    boff = OFF_B3;
  }
  float* P = part + (size_t)split * BLOCK_FLOATS;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int n = 8 * (nb0 + nb) + 2 * t;
    if (n >= wd) continue;  // wd % 4 == 0: n + 1 < wd too
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + g + 8 * i;
      if (m < wa)
        *reinterpret_cast<float2*>(P + woff + m * ldw + n) =
            make_float2(acc[nb][2 * i], acc[nb][2 * i + 1]);
    }
  }
  if (bias && threadIdx.x < wd) P[boff + j0 + threadIdx.x] = bacc;

  // the tile's last split sums every split's partial in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // four floats a thread, every split's load in flight before the sums
  const int splits = gridDim.y, wd4 = wd / 4;
  auto sum_splits = [&](size_t off) {
    float4 p[MAX_SPLITS];
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      p[k] = k < splits ? __ldcg(reinterpret_cast<const float4*>(
                              part + (size_t)k * BLOCK_FLOATS + off))
                        : zero4;
    float4 s = zero4;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k) {
      if (k >= splits) break;
      s.x += p[k].x;
      s.y += p[k].y;
      s.z += p[k].z;
      s.w += p[k].w;
    }
    *reinterpret_cast<float4*>(dw + off) = s;
  };
  for (int idx = threadIdx.x; idx < wa * wd4; idx += NT)
    sum_splits(woff + (idx / wd4) * ldw + 4 * (idx % wd4));
  if (bias)
    for (int n4 = threadIdx.x; n4 < wd4; n4 += NT) sum_splits(boff + j0 + 4 * n4);
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

size_t act_smem(int R) {
  return ((size_t)SMEM_W_FLOATS + (size_t)R * ACT_ROW_FLOATS) * sizeof(float);
}

size_t input_smem(int tile, int halo) {
  return ((size_t)SMEM_W_FLOATS + (size_t)(tile + halo) * LDF +
          (size_t)tile * (LDF + LDH)) * sizeof(float);
}

struct Scratch {
  float *u1s, *a2s, *a3s, *dys, *du1s, *hst, *part;
  int* counters;
};

// The shared-memory opt-in of the window kernels for dilations up to d.
cudaError_t allow_smem(int tile, int d) {
  const int halo = (KS - 1) * d;
  cudaError_t e = cudaFuncSetAttribute(tcn_bwd_act_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)act_smem(tile + halo));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(tcn_bwd_input_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)input_smem(tile, halo));
}

// One block's three launches; adds one to *launched for each kernel launched.
cudaError_t block_backward(const float* h, const float* dout, float* dh,
                           const float* w, const float* wt, float* dw, int d,
                           int B, int T, int tile, int splits, const Scratch& s,
                           cudaStream_t stream, int* launched) {
  const int halo = (KS - 1) * d;
  const size_t smem1 = act_smem(tile + halo), smem2 = input_smem(tile, halo);
  cudaError_t e;
  const dim3 grid((T + tile - 1) / tile, B);
  tcn_bwd_act_kernel<<<grid, NT, smem1, stream>>>(h, dout, w, wt, d, T, tile, s.u1s,
                                                  s.a2s, s.a3s, s.dys, s.hst);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  tcn_bwd_input_kernel<<<grid, NT, smem2, stream>>>(h, dout, wt, s.u1s, s.dys, s.hst,
                                                    d, T, tile, s.du1s, dh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  tcn_bwd_wgrad_kernel<<<dim3(WG_TILES, splits), NT, 0, stream>>>(
      h, s.hst, s.a2s, s.a3s, s.dys, s.du1s, dout, d, T, B * T, s.part,
      s.counters, dw);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int tcn_train_block_floats() { return BLOCK_FLOATS; }

int tcn_train_block_t_floats() { return BLOCK_T_FLOATS; }

int tcn_train_wgrad_tiles() { return WG_TILES; }

// Largest window (tile + 2d rows) the first backward kernel's CTA can hold
// on `device`; the second kernel's CTA needs less.
int tcn_train_max_window_rows(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return (optin - (int)(SMEM_W_FLOATS * sizeof(float))) /
         (int)(ACT_ROW_FLOATS * sizeof(float));
}

// Backward of a group of G blocks, in reverse, three launches a block on
// `stream`: hs[g] the input [B, T, C] of block g (host array of device
// pointers), w [G, block floats] and wt [G, block_t floats] the packed and
// transposed weights, dil[g] (host array) the dilations; dout [B, T, C] the
// gradient of the group's output; block g's input gradient goes to
// dbuf[g % 2] (so dh of the group is dbuf0; neither aliases dout). u1s,
// a2s, a3s, dys, du1s [B*T, DF], hst [B*T, 2] and part [splits, block
// floats] are scratch; counters [wgrad tiles] zeros (left zero); dw
// [G, block floats] the packed gradients (overwritten). *launched is set to
// the number of kernels launched, also when an error stops the walk.
int tcn_group_backward(const void* const* hs, const void* dout, void* dbuf0,
                       void* dbuf1, const void* w, const void* wt, const int* dil,
                       int G, int B, int T, int tile, int splits, void* u1s,
                       void* a2s, void* a3s, void* dys, void* du1s, void* hst,
                       void* part, void* counters, void* dw, void* stream,
                       int* launched) {
  *launched = 0;
  if (G < 1 || B < 1 || T < 1 || tile < 1 || splits < 1 || splits > MAX_SPLITS)
    return cudaErrorInvalidValue;
  int d_max = 0;
  for (int g = 0; g < G; ++g) {
    if (dil[g] < 1) return cudaErrorInvalidValue;
    d_max = dil[g] > d_max ? dil[g] : d_max;
  }
  const cudaError_t e0 = allow_smem(tile, d_max);
  if (e0 != cudaSuccess) return e0;
  const Scratch s{(float*)u1s, (float*)a2s, (float*)a3s, (float*)dys,
                  (float*)du1s, (float*)hst, (float*)part, (int*)counters};
  float* bufs[2] = {(float*)dbuf0, (float*)dbuf1};
  const float* d = (const float*)dout;
  for (int g = G - 1; g >= 0; --g) {
    const float* h = (const float*)hs[g];
    const float* wg = (const float*)w + (size_t)g * BLOCK_FLOATS;
    const float* wtg = (const float*)wt + (size_t)g * BLOCK_T_FLOATS;
    float* dwg = (float*)dw + (size_t)g * BLOCK_FLOATS;
    const cudaError_t e = block_backward(h, d, bufs[g % 2], wg, wtg, dwg, dil[g], B,
                                         T, tile, splits, s, (cudaStream_t)stream, launched);
    if (e != cudaSuccess) return e;
    d = bufs[g % 2];
  }
  return cudaSuccess;
}

}  // extern "C"
