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
// so tcn_block_backward walks ONE block at a time, reading its input h from
// device memory, in four launches:
//   1. tcn_bwd_act_kernel, one CTA per (time tile, batch row): recomputes
//      a = LN(relu(h)), u1, a2 (over the tile plus the 2d rows before it that
//      the dilated conv reads; pre-sequence rows of a2 zero), y, a3, then
//      da3 = dout W3^T and dy = LN'(da3) * (y > 0). Writes u1, a2, a3, dy and
//      the moments of relu(h) for the tile rows to a scratch of [B*T, 64]
//      buffers (0.5 MB each at B 8, T 256).
//   2. tcn_bwd_input_kernel, one CTA per (time tile, batch row): the conv's
//      input gradient reaches FORWARD, da2[t] = sum_j dy[t + (k-1-j) d] W2[j]^T,
//      so the CTA reads dy over the tile and the 2d rows after it (zero past
//      T); then du1 = LN'(da2) * (u1 > 0), da = du1 W1^T and
//      dh = dout + LN'(da) * (h > 0).
//   3. tcn_bwd_wgrad_kernel: dW1 = a^T du1, dW2[j] = a2(shifted by (k-1-j) d)^T dy,
//      dW3 = a3^T dout and the bias sums. 11 output tiles of 64 x 64, each
//      contracting over a fixed slice (split) of the B*T rows; every split
//      writes its own partial copy of the block's packed gradients. No atomics.
//   4. tcn_bwd_reduce_kernel sums the splits in a fixed order, so the weight
//      gradients are bitwise the same from run to run.
// Products are register-tiled FMA loops (tcn_common.cuh's unit_product, and a
// 4 x 4 a thread outer-product loop for the weight gradients). The input
// gradient products read transposed weights packed by the wrapper
// (w1t [64, 256], w2t[j] = W2[j]^T, w3t [256, 64]).
//
// What bounds it on this card: per row and block the backward computes the
// recompute's two products (57,344 FLOP), the input gradients (90,112) and
// the weight gradients (90,112), 237,568 FLOP against ~4 KB of activations
// and gradients moved, so it is bound by operations: 19.5 GFLOP for 40
// blocks at B 8, T 256, 0.29 ms at the 67 TFLOP/s f32 CUDA-core peak.

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

constexpr int WG_RC = 32;    // rows per chunk of the weight-gradient loop
constexpr int WG_TILES = 11; // 4 of dW1 (256 x 64), 3 of dW2, 4 of dW3 (64 x 256)

__global__ void __launch_bounds__(NT, 2)
tcn_bwd_act_kernel(const float* __restrict__ h, const float* __restrict__ dout,
                   const float* __restrict__ w, const float* __restrict__ wt,
                   int d, int T, int tile, float* __restrict__ u1s,
                   float* __restrict__ a2s, float* __restrict__ a3s,
                   float* __restrict__ dys, float* __restrict__ hst) {
  extern __shared__ float4 smem4[];
  const int halo = (KS - 1) * d;
  const int R = tile + halo;
  float* hw = reinterpret_cast<float*>(smem4);
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
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int idx = threadIdx.x; idx < nrows * (C / 4); idx += NT) {
    const int r = idx / (C / 4), c4 = idx % (C / 4);
    const int t = first + r;
    reinterpret_cast<float4*>(hw + r * LDH)[c4] =
        t >= 0 ? __ldg(reinterpret_cast<const float4*>(h + (row0 + t) * C) + c4)
               : zero4;
  }
  __syncthreads();
  h_moments(hw, st, 0, nrows);
  __syncthreads();
  unit_product<C, DF, 1, true, false>(hw, LDH, st, w + OFF_W1, w + OFF_B1, 0,
                                      a2, LDF, 0, nrows);
  __syncthreads();
  // u1 and the moments of relu(h) on the tile rows, for the next kernels;
  // dout replaces h, which is not read again
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
  for (int idx = threadIdx.x; idx < (nrows - halo) * (C / 4); idx += NT) {
    const int r = halo + idx / (C / 4), c4 = idx % (C / 4);
    reinterpret_cast<float4*>(hw + r * LDH)[c4] = __ldg(
        reinterpret_cast<const float4*>(dout + (row0 + (first + r)) * C) + c4);
  }
  __syncthreads();
  relu_ln_inplace(a2, 0, nrows, pre_rows);
  __syncthreads();
  for (int idx = threadIdx.x; idx < (nrows - halo) * (DF / 4); idx += NT) {
    const int r = halo + idx / (DF / 4), c4 = idx % (DF / 4);
    reinterpret_cast<float4*>(a2s + (row0 + (first + r)) * DF)[c4] =
        reinterpret_cast<const float4*>(a2 + r * LDF)[c4];
  }
  // y = conv(a2) + b2 and da3 = dout W3^T on the tile rows
  unit_product<DF, DF, KS, false, false>(a2, LDF, nullptr, w + OFF_W2,
                                         w + OFF_B2, d, yb, LDF, halo, nrows);
  unit_product<C, DF, 1, false, false, false>(hw, LDH, nullptr, wt + OFFT_W3T,
                                              nullptr, 0, db, LDF, halo, nrows);
  __syncthreads();
  // a3 = LN(relu(y)), dy = LN'(da3; relu(y)) * (y > 0)
  for (int r = halo + warp; r < nrows; r += NT / 32) {
    float z[DF / 32], mu, rstd;
    relu_moments<DF>(yb + r * LDF, lane, z, mu, rstd);
    float zh[DF / 32], u[DF / 32], su = 0.f, suz = 0.f;
#pragma unroll
    for (int e = 0; e < DF / 32; ++e) {
      zh[e] = (z[e] - mu) * rstd;
      u[e] = db[r * LDF + lane + 32 * e];
      su += u[e];
      suz += u[e] * zh[e];
    }
    su = warp_sum(su) * (1.f / DF);
    suz = warp_sum(suz) * (1.f / DF);
    const size_t gr = row0 + (first + r);
#pragma unroll
    for (int e = 0; e < DF / 32; ++e) {
      a3s[gr * DF + lane + 32 * e] = zh[e];
      dys[gr * DF + lane + 32 * e] =
          z[e] > 0.f ? rstd * (u[e] - su - zh[e] * suz) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
tcn_bwd_input_kernel(const float* __restrict__ h,
                     const float* __restrict__ dout,
                     const float* __restrict__ wt,
                     const float* __restrict__ u1s,
                     const float* __restrict__ dys,
                     const float* __restrict__ hst, int d, int T, int tile,
                     float* __restrict__ du1s, float* __restrict__ dh) {
  extern __shared__ float4 smem4[];
  const int halo = (KS - 1) * d;
  float* dyw = reinterpret_cast<float*>(smem4);  // rows t0 .. t0+tile+halo-1
  float* g2 = dyw + (tile + halo) * LDF;           // da2, then du1
  float* ga = g2 + tile * LDF;                     // da

  const int t0 = blockIdx.x * tile;
  const int n = min(tile, T - t0);
  const size_t row0 = (size_t)blockIdx.y * T + t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < (n + halo) * (DF / 4); idx += NT) {
    const int r = idx / (DF / 4), c4 = idx % (DF / 4);
    reinterpret_cast<float4*>(dyw + r * LDF)[c4] =
        t0 + r < T
            ? __ldg(reinterpret_cast<const float4*>(dys + (row0 + r) * DF) + c4)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  // da2[r] = sum_j dy[r + (KS-1-j) d] W2[j]^T: a negative dilation reads ahead
  unit_product<DF, DF, KS, false, false, false>(dyw, LDF, nullptr,
                                                wt + OFFT_W2T, nullptr, -d, g2,
                                                LDF, 0, n);
  __syncthreads();
  // du1 = LN'(da2; relu(u1)) * (u1 > 0)
  for (int r = warp; r < n; r += NT / 32) {
    float z[DF / 32], mu, rstd;
    relu_moments<DF>(u1s + (row0 + r) * DF, lane, z, mu, rstd);
    float zh[DF / 32], u[DF / 32], su = 0.f, suz = 0.f;
#pragma unroll
    for (int e = 0; e < DF / 32; ++e) {
      zh[e] = (z[e] - mu) * rstd;
      u[e] = g2[r * LDF + lane + 32 * e];
      su += u[e];
      suz += u[e] * zh[e];
    }
    su = warp_sum(su) * (1.f / DF);
    suz = warp_sum(suz) * (1.f / DF);
#pragma unroll
    for (int e = 0; e < DF / 32; ++e) {
      const float v = z[e] > 0.f ? rstd * (u[e] - su - zh[e] * suz) : 0.f;
      g2[r * LDF + lane + 32 * e] = v;
      du1s[(row0 + r) * DF + lane + 32 * e] = v;
    }
  }
  __syncthreads();
  // da = du1 W1^T
  unit_product<DF, C, 1, false, false, false>(g2, LDF, nullptr, wt + OFFT_W1T,
                                              nullptr, 0, ga, LDH, 0, n);
  __syncthreads();
  // dh = dout + LN'(da; relu(h)) * (h > 0), with the forward's moments
  for (int r = warp; r < n; r += NT / 32) {
    const size_t gr = row0 + r;
    const float sh = hst[2 * gr], sc = hst[2 * gr + 1];
    float hv[C / 32], zh[C / 32], u[C / 32], su = 0.f, suz = 0.f;
#pragma unroll
    for (int e = 0; e < C / 32; ++e) {
      hv[e] = h[gr * C + lane + 32 * e];
      zh[e] = fmaf(fmaxf(hv[e], 0.f), sc, sh);
      u[e] = ga[r * LDH + lane + 32 * e];
      su += u[e];
      suz += u[e] * zh[e];
    }
    su = warp_sum(su) * (1.f / C);
    suz = warp_sum(suz) * (1.f / C);
#pragma unroll
    for (int e = 0; e < C / 32; ++e) {
      const size_t o = gr * C + lane + 32 * e;
      dh[o] = dout[o] + (hv[e] > 0.f ? sc * (u[e] - su - zh[e] * suz) : 0.f);
    }
  }
}

// blockIdx.x: output tile (0-3 dW1 rows 64x, 4-6 dW2 tap, 7-10 dW3 columns
// 64x); blockIdx.y: split of the N = B*T rows. Writes the split's partial
// gradients into part[split] in the packed block layout.
__global__ void __launch_bounds__(NT)
tcn_bwd_wgrad_kernel(const float* __restrict__ h,
                     const float* __restrict__ hst,
                     const float* __restrict__ a2s,
                     const float* __restrict__ a3s,
                     const float* __restrict__ dys,
                     const float* __restrict__ du1s,
                     const float* __restrict__ dout, int d, int T, int N,
                     float* __restrict__ part) {
  __shared__ __align__(16) float As[WG_RC][LDF];
  __shared__ __align__(16) float Ds[WG_RC][LDF];
  const int tile = blockIdx.x, split = blockIdx.y;
  int job, i0 = 0, j0 = 0, tap = 0;
  if (tile < 4) {
    job = 0;  // dW1 = a^T du1, rows i0 .. i0+63
    i0 = 64 * tile;
  } else if (tile < 7) {
    job = 1;  // dW2[tap] = a2(t - (KS-1-tap) d)^T dy
    tap = tile - 4;
  } else {
    job = 2;  // dW3 = a3^T dout, columns j0 .. j0+63
    j0 = 64 * (tile - 7);
  }
  const int shift = (KS - 1 - tap) * d;
  const bool bias = (job == 0 && i0 == 0) || (job == 1 && tap == 0) || job == 2;
  const int r_begin = (int)((long long)N * split / gridDim.y);
  const int r_end = (int)((long long)N * (split + 1) / gridDim.y);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float bacc = 0.f;

  for (int rc = r_begin; rc < r_end; rc += WG_RC) {
    for (int idx = threadIdx.x; idx < WG_RC * 16; idx += NT) {
      const int rr = idx / 16, c4 = idx % 16;
      const int r = rc + rr;
      float4 a = zero4, g = zero4;
      if (r < r_end) {
        if (job == 0) {
          const float4 hv =
              __ldg(reinterpret_cast<const float4*>(h + (size_t)r * C + i0) + c4);
          const float sh = hst[2 * (size_t)r], sc = hst[2 * (size_t)r + 1];
          a = make_float4(fmaf(fmaxf(hv.x, 0.f), sc, sh),
                          fmaf(fmaxf(hv.y, 0.f), sc, sh),
                          fmaf(fmaxf(hv.z, 0.f), sc, sh),
                          fmaf(fmaxf(hv.w, 0.f), sc, sh));
          g = __ldg(reinterpret_cast<const float4*>(du1s + (size_t)r * DF) + c4);
        } else if (job == 1) {
          if (r % T >= shift)
            a = __ldg(reinterpret_cast<const float4*>(
                          a2s + (size_t)(r - shift) * DF) + c4);
          g = __ldg(reinterpret_cast<const float4*>(dys + (size_t)r * DF) + c4);
        } else {
          a = __ldg(reinterpret_cast<const float4*>(a3s + (size_t)r * DF) + c4);
          g = __ldg(reinterpret_cast<const float4*>(dout + (size_t)r * C + j0) +
                    c4);
        }
      }
      *reinterpret_cast<float4*>(&As[rr][4 * c4]) = a;
      *reinterpret_cast<float4*>(&Ds[rr][4 * c4]) = g;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < WG_RC; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&As[rr][4 * ty]);
      const float4 g = *reinterpret_cast<const float4*>(&Ds[rr][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], g.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], g.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], g.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], g.w, acc[i][3]);
      }
    }
    if (bias && threadIdx.x < 64)
      for (int rr = 0; rr < WG_RC; ++rr) bacc += Ds[rr][threadIdx.x];
    __syncthreads();
  }

  float* P = part + (size_t)split * BLOCK_FLOATS;
  float* Wt;
  int ldw;
  if (job == 0) {
    Wt = P + OFF_W1 + i0 * DF;
    ldw = DF;
  } else if (job == 1) {
    Wt = P + OFF_W2 + tap * DF * DF;
    ldw = DF;
  } else {
    Wt = P + OFF_W3 + j0;
    ldw = C;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(Wt + (4 * ty + i) * ldw + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (bias && threadIdx.x < 64) {
    float* bp = job == 0 ? P + OFF_B1 : job == 1 ? P + OFF_B2 : P + OFF_B3 + j0;
    bp[threadIdx.x] = bacc;
  }
}

// dw[e] = sum over splits s = 0, 1, ... of part[s][e], in that order.
__global__ void tcn_bwd_reduce_kernel(const float* __restrict__ part,
                                      int splits, float* __restrict__ dw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= BLOCK_FLOATS) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * BLOCK_FLOATS + e];
  dw[e] = s;
}

}  // namespace

extern "C" {

int tcn_train_block_floats() { return BLOCK_FLOATS; }

int tcn_train_block_t_floats() { return BLOCK_T_FLOATS; }

const char* tcn_train_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Backward of one block: h, dout, dh [B, T, 256] (dh not aliasing dout);
// w, wt the block's packed and transposed weights; u1s, a2s, a3s, dys, du1s
// [B*T, 64], hst [B*T, 2] and part [splits, block floats] scratch; dw the
// block's packed gradients (overwritten). Launches four kernels on `stream`.
int tcn_block_backward(const void* h, const void* dout, void* dh,
                       const void* w, const void* wt, int d, int B, int T,
                       int tile, int splits, void* u1s, void* a2s, void* a3s,
                       void* dys, void* du1s, void* hst, void* part, void* dw,
                       void* stream) {
  if (d < 1 || B < 1 || T < 1 || tile < 1 || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  const int halo = (KS - 1) * d;
  const size_t smem1 = (size_t)(tile + halo) * ACT_ROW_FLOATS * sizeof(float);
  const size_t smem2 =
      (size_t)((tile + halo) * LDF + tile * (LDF + LDH)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      tcn_bwd_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(tcn_bwd_input_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem2);
  if (e != cudaSuccess) return e;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((T + tile - 1) / tile, B);
  tcn_bwd_act_kernel<<<grid, NT, smem1, s>>>(
      (const float*)h, (const float*)dout, (const float*)w, (const float*)wt,
      d, T, tile, (float*)u1s, (float*)a2s, (float*)a3s, (float*)dys,
      (float*)hst);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tcn_bwd_input_kernel<<<grid, NT, smem2, s>>>(
      (const float*)h, (const float*)dout, (const float*)wt,
      (const float*)u1s, (const float*)dys, (const float*)hst, d, T, tile,
      (float*)du1s, (float*)dh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tcn_bwd_wgrad_kernel<<<dim3(WG_TILES, splits), NT, 0, s>>>(
      (const float*)h, (const float*)hst, (const float*)a2s,
      (const float*)a3s, (const float*)dys, (const float*)du1s,
      (const float*)dout, d, T, B * T, (float*)part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tcn_bwd_reduce_kernel<<<(BLOCK_FLOATS + NT - 1) / NT, NT, 0, s>>>(
      (const float*)part, splits, (float*)dw);
  return cudaGetLastError();
}

}  // extern "C"
