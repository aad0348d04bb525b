// Fused ResNetV2 bottleneck blocks for Hopper (sm_90a), float32 values.
//
// Replaces the Pallas kernels of deepxi_tpu/ops/kernels/tcn_fused.py:
//   * tcn_block_forward  -> fused_block_group_whole (whole sequence in VMEM),
//     launched once per block of the group, ping-ponging between two buffers
//     because neighbouring tiles read each other's halo rows of the input;
//   * tcn_block_forward_pack2 -> fused_block_group_whole_pack2 (two batch
//     rows per grid cell, packed into the d_f lanes with block-diagonal
//     weights), launched once per block like tcn_block_forward;
//   * tcn_group_forward  -> fused_block_group (halo-tiled), launched once per
//     group: each CTA carries the shrinking window of its tile through all
//     G blocks, as the Pallas kernel does.
//
// The block, the weight layout, the widths (build defines) and the shared
// device helpers are in tcn_common.cuh.
//
// What bounds it on this card (resnet-1.1c's widths, C 256, DF 64, k 3):
// 90,112 FLOP per row per block against 2 KB of activations in and out per
// group, so the work is bound by operations. At B=96, T=625 the 40 blocks
// are 216 GFLOP: 3.2 ms at the 67 TFLOP/s f32 CUDA-core peak, 1.3 ms at the
// 165 TFLOP/s of f32-accurate (3xTF32) tensor-core products, against ~73 us
// of HBM traffic a group (123 MB a block when each block is its own launch:
// 37 us). The TPU keeps a [<=1024, 256] sequence (1 MB) resident; a Hopper
// block has 227 KB of shared memory, so this design tiles time and
// recomputes the causal halo.
//
// Design: 256 threads (8 warps) per CTA, one CTA per (time tile, batch row).
// The three products run on the tensor cores as m16n8k8 TF32 products
// split hi/lo to f32 accuracy (tcn_common.cuh's mma_product): a warp takes
// 32 rows (16 for tiles under 32 rows and for pack2) by 32 columns at a
// time, its A operand read from the window in shared memory, its B operand
// from the unit's weights, which are staged in shared memory once per CTA
// and unit with cp.async (W1 74 KB, the conv 55 KB, W3 68 KB at the
// flagship widths, one buffer) while the LayerNorm pass before the unit
// runs. LayerNorm is one warp per row with shuffle
// reductions; the first unit's LN is applied while its A fragments are
// built, from per-row moments, so h needs no normalised copy. The window
// takes what the weight buffer leaves: 99 rows at the flagship widths (a
// 64-row tile and the d = 16 conv's 32-row reach; the halo-tiled route 48 +
// 48 rows, two blocks a launch).
//
// pack2: the TPU kernel packs rows 2b and 2b+1 side by side in the lanes so
// that its matrix unit sees N, K >= 128, multiplying block-diagonal zeros.
// Here a CTA holds the same time tile of both rows (NB = 2 windows, one after
// the other in shared memory) and each B fragment a warp splits feeds the
// products of both rows, with no zeros multiplied. Its segmented LayerNorms
// are two-pass per row ("slice") or one-pass, E[x^2] - E[x]^2 ("matmul",
// ONE_PASS), as the JAX ln_mode says; the LN of h stays two-pass in both. An
// odd B gives the last CTA a zero second row, computed and never written.

#include "tcn_common.cuh"

namespace {

constexpr int ROW_FLOATS = LDH + 2 * LDF + 2;  // h, a2, y, LN moments
constexpr int MAX_G = 40;
// A unit's weights go to shared memory when a 64-row window still fits
// beside them (the flagship's: 74 KB and 99 rows); wider ones are read
// from global memory through L1/L2 (a build define, not a run-time choice).
constexpr bool W_SMEM =
    ((size_t)WBUF_FLOATS + 64 * (size_t)ROW_FLOATS) * sizeof(float) <= 232448;
constexpr int SMEM_W_FLOATS = W_SMEM ? WBUF_FLOATS : 0;

struct Dilations {
  int d[MAX_G];
};

// Floats between the windows of a CTA's batch rows: R rows, 16-byte aligned.
__host__ __device__ inline int window_floats(int R) {
  return (R * ROW_FLOATS + 3) & ~3;
}

// One CTA: batch rows NB * blockIdx.y + n (n < NB; rows >= B are zeros and
// not written), output rows [t0, t0 + tile) with t0 = blockIdx.x * tile.
// Each row's window holds rows t0 - halo .. t0 + tile - 1 of h (rows before
// t = 0 as zeros). Block g computes its units on the window rows still
// needed downstream and shrinks the window by its reach (KS-1) d; after G
// blocks the last `tile` rows are the output. The next unit's weights land
// in the one weight buffer while the LayerNorm pass before it runs.
template <int NB, int MS, bool ONE_PASS>
__global__ void __launch_bounds__(NT, 1)
tcn_window_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const float* __restrict__ wpack, Dilations dil, int G,
                  int B, int T, int tile, int halo) {
  extern __shared__ float4 smem4[];
  float* wbuf = reinterpret_cast<float*>(smem4);
  const int R = tile + halo;
  const int bs = window_floats(R);
  float* h = wbuf + SMEM_W_FLOATS;
  float* a2 = h + R * LDH;
  float* yb = a2 + R * LDF;
  float* st = yb + R * LDF;

  const int t0 = blockIdx.x * tile;
  const int first = t0 - halo;  // time of window row 0
  const int nrows = halo + min(tile, T - t0);
  const int pre_rows = max(0, -first);
  const int b0 = blockIdx.y * NB;

  for (int n = 0; n < NB; ++n) {
    const size_t row0 = (size_t)(b0 + n) * T;
    const bool real = b0 + n < B;
    for (int idx = threadIdx.x; idx < nrows * (C / 4); idx += NT) {
      const int r = idx / (C / 4), c4 = idx % (C / 4);
      const int t = first + r;
      const bool in = real && t >= 0;
      cp_async16(h + n * bs + r * LDH + 4 * c4,
                 in ? x + (row0 + t) * C + 4 * c4 : x, !in);
    }
    if constexpr (DF != DFP) {  // the padding columns the products read stay zero
      constexpr int PAD = DFP - DF > 0 ? DFP - DF : 1;
      for (int idx = threadIdx.x; idx < 2 * R * PAD; idx += NT)
        a2[n * bs + idx / PAD * LDF + DF + idx % PAD] = 0.f;
    }
  }
  cp_async_commit();
  stage_unit<W_SMEM, C, DF, 1>(wbuf, wpack + OFF_W1);

  int s = 0;  // first window row still needed
  for (int g = 0; g < G; ++g) {
    const int d = dil.d[g], reach = (KS - 1) * d;
    const float* Wb = wpack + (size_t)g * BLOCK_FLOATS;
    if (g == 0) {
      cp_async_wait<1>();  // the window; W1 may still be in flight
      __syncthreads();
    }
    for (int n = 0; n < NB; ++n) h_moments(h + n * bs, st + n * bs, s, nrows);
    cp_async_wait<0>();
    __syncthreads();
    mma_product<C, DF, 1, true, false, NB, MS, W_SMEM>(
        h, LDH, st, W_SMEM ? wbuf : Wb + OFF_W1, Wb + OFF_B1, 0, a2, LDF, s,
        nrows, bs);
    __syncthreads();
    stage_unit<W_SMEM, DF, DF, KS>(wbuf, Wb + OFF_W2);
    for (int n = 0; n < NB; ++n)
      relu_ln_inplace<ONE_PASS>(a2 + n * bs, s, nrows, pre_rows);
    cp_async_wait<0>();
    __syncthreads();
    mma_product<DF, DF, KS, false, false, NB, MS, W_SMEM>(
        a2, LDF, nullptr, W_SMEM ? wbuf : Wb + OFF_W2, Wb + OFF_B2, d, yb, LDF,
        s + reach, nrows, bs);
    __syncthreads();
    stage_unit<W_SMEM, DF, C, 1>(wbuf, Wb + OFF_W3);
    for (int n = 0; n < NB; ++n)
      relu_ln_inplace<ONE_PASS>(yb + n * bs, s + reach, nrows, 0);
    cp_async_wait<0>();
    __syncthreads();
    mma_product<DF, C, 1, false, true, NB, MS, W_SMEM>(
        yb, LDF, nullptr, W_SMEM ? wbuf : Wb + OFF_W3, Wb + OFF_B3, 0, h, LDH,
        s + reach, nrows, bs);
    __syncthreads();
    if (g + 1 < G) stage_unit<W_SMEM, C, DF, 1>(wbuf, Wb + BLOCK_FLOATS + OFF_W1);
    s += reach;
  }

  for (int n = 0; n < NB && b0 + n < B; ++n) {
    const size_t row0 = (size_t)(b0 + n) * T;
    for (int idx = threadIdx.x; idx < (nrows - halo) * (C / 4); idx += NT) {
      const int r = halo + idx / (C / 4), c4 = idx % (C / 4);
      reinterpret_cast<float4*>(y + (row0 + first + r) * C)[c4] =
          reinterpret_cast<const float4*>(h + n * bs + r * LDH)[c4];
    }
  }
}

template <int NB, int MS, bool ONE_PASS>
cudaError_t launch_ms(const void* x, void* y, const void* wpack,
                      const Dilations& dil, int G, int B, int T, int tile,
                      int halo, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      tcn_window_kernel<NB, MS, ONE_PASS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + tile - 1) / tile, (B + NB - 1) / NB);
  tcn_window_kernel<NB, MS, ONE_PASS><<<grid, NT, smem, stream>>>(
      (const float*)x, (float*)y, (const float*)wpack, dil, G, B, T, tile,
      halo);
  return cudaGetLastError();
}

// Two slabs an item (each B fragment feeding 32 rows) where the tile has
// rows for them, one for short tiles and for pack2, whose two windows
// already share each B fragment.
template <int NB, bool ONE_PASS>
int launch(const void* x, void* y, const void* wpack, const Dilations& dil,
           int G, int B, int T, int tile, int halo, void* stream) {
  if (G < 1 || G > MAX_G || B < 1 || T < 1 || tile < 1 || halo < 0)
    return cudaErrorInvalidValue;
  const int R = tile + halo;
  const size_t smem = ((size_t)SMEM_W_FLOATS + (size_t)(NB - 1) * window_floats(R) +
                       (size_t)R * ROW_FLOATS) * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  if (NB == 1 && tile >= 32)
    return launch_ms<NB, 2, ONE_PASS>(x, y, wpack, dil, G, B, T, tile, halo, smem, s);
  return launch_ms<NB, 1, ONE_PASS>(x, y, wpack, dil, G, B, T, tile, halo, smem, s);
}

}  // namespace

extern "C" {

// Largest window (tile + halo rows) one CTA can hold on `device` beside
// the weight buffer.
int tcn_max_window_rows(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return (optin - (int)(SMEM_W_FLOATS * sizeof(float))) /
         (int)(ROW_FLOATS * sizeof(float));
}

int tcn_block_floats() { return BLOCK_FLOATS; }

const char* tcn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One bottleneck block over x [B, T, C] -> y (not in place): w points at
// the block's packed weights, d is its dilation; halo = 2d.
int tcn_block_forward(const void* x, void* y, const void* w, int d, int B,
                      int T, int tile, void* stream) {
  Dilations dil{};
  dil.d[0] = d;
  return launch<1, false>(x, y, w, dil, 1, B, T, tile, (KS - 1) * d, stream);
}

// The same block over rows 2b and 2b+1 in one CTA (an odd B's last CTA has a
// zero second row); ln_matmul != 0 takes the one-pass segmented LayerNorm.
// One CTA needs 2 (tile + 2d) + 1 of tcn_max_window_rows' rows.
int tcn_block_forward_pack2(const void* x, void* y, const void* w, int d,
                            int B, int T, int tile, int ln_matmul,
                            void* stream) {
  Dilations dil{};
  dil.d[0] = d;
  const int halo = (KS - 1) * d;
  return ln_matmul ? launch<2, true>(x, y, w, dil, 1, B, T, tile, halo, stream)
                   : launch<2, false>(x, y, w, dil, 1, B, T, tile, halo, stream);
}

// G consecutive blocks over x -> y (not in place): w points at G packed
// blocks, dil (host memory) at their G dilations; halo >= sum (KS-1) d.
int tcn_group_forward(const void* x, void* y, const void* w, const int* dil,
                      int G, int B, int T, int tile, int halo, void* stream) {
  if (G < 1 || G > MAX_G) return cudaErrorInvalidValue;
  Dilations ds{};
  for (int g = 0; g < G; ++g) ds.d[g] = dil[g];
  return launch<1, false>(x, y, w, ds, G, B, T, tile, halo, stream);
}

}  // extern "C"
