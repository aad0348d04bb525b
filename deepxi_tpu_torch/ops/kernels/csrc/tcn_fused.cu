// Fused ResNetV2 bottleneck blocks for Hopper (sm_90a), float32 throughout.
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
// 90,112 FLOP per row per block against
// 2 KB of activations in and out per group, so the work is bound by
// operations. At B=96, T=625 the 40 blocks are 216 GFLOP: 3.2 ms at the
// 67 TFLOP/s f32 CUDA-core peak, against ~73 us of HBM traffic. The TPU keeps
// a [<=1024, 256] sequence (1 MB) resident; a Hopper block has 227 KB of shared
// memory, so this design tiles time and recomputes the causal halo. Weights
// (7.8 MB for 40 blocks) are read through L1/L2 with read-only loads.
//
// Design (simple first): 256 threads per CTA, one CTA per (time tile, batch
// row). Products are register-tiled FMA loops, 4 rows x 4 columns a thread,
// A operand from shared memory, weights as float4 loads. LayerNorm is one
// warp per row with shuffle reductions. The first unit's LN is applied on the
// fly from per-row moments, so h needs no normalised copy.
//
// pack2: the TPU kernel packs rows 2b and 2b+1 side by side in the lanes so
// that its matrix unit sees N, K >= 128, multiplying block-diagonal zeros.
// Here a CTA holds the same time tile of both rows (NB = 2 windows, one after
// the other in shared memory) and each weight float4 a thread loads feeds the
// FMAs of both rows: half the weight loads per FLOP, and no zeros multiplied.
// Its segmented LayerNorms are two-pass per row ("slice") or one-pass,
// E[x^2] - E[x]^2 ("matmul", ONE_PASS), as the JAX ln_mode says; the LN of h
// stays two-pass in both. An odd B gives the last CTA a zero second row,
// computed and never written.

#include "tcn_common.cuh"

namespace {

constexpr int ROW_FLOATS = LDH + 2 * LDF + 2;  // h, a2, y, LN moments
constexpr int MAX_G = 40;

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
// blocks the last `tile` rows are the output.
template <int NB, bool ONE_PASS>
__global__ void __launch_bounds__(NT, 3 - NB)
tcn_window_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const float* __restrict__ wpack, Dilations dil, int G,
                  int B, int T, int tile, int halo) {
  extern __shared__ float4 smem4[];
  const int R = tile + halo;
  const int bs = window_floats(R);
  float* h = reinterpret_cast<float*>(smem4);
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
      const float4 v =
          real && t >= 0
              ? __ldg(reinterpret_cast<const float4*>(x + (row0 + t) * C) + c4)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(h + n * bs + r * LDH)[c4] = v;
    }
  }
  __syncthreads();

  int s = 0;  // first window row still needed
  for (int g = 0; g < G; ++g) {
    const int d = dil.d[g], reach = (KS - 1) * d;
    const float* Wb = wpack + (size_t)g * BLOCK_FLOATS;
    for (int n = 0; n < NB; ++n) h_moments(h + n * bs, st + n * bs, s, nrows);
    __syncthreads();
    unit_product<C, DF, 1, true, false, true, NB>(
        h, LDH, st, Wb + OFF_W1, Wb + OFF_B1, 0, a2, LDF, s, nrows, bs);
    __syncthreads();
    for (int n = 0; n < NB; ++n)
      relu_ln_inplace<ONE_PASS>(a2 + n * bs, s, nrows, pre_rows);
    __syncthreads();
    unit_product<DF, DF, KS, false, false, true, NB>(
        a2, LDF, nullptr, Wb + OFF_W2, Wb + OFF_B2, d, yb, LDF, s + reach,
        nrows, bs);
    __syncthreads();
    for (int n = 0; n < NB; ++n)
      relu_ln_inplace<ONE_PASS>(yb + n * bs, s + reach, nrows, 0);
    __syncthreads();
    unit_product<DF, C, 1, false, true, true, NB>(
        yb, LDF, nullptr, Wb + OFF_W3, Wb + OFF_B3, 0, h, LDH, s + reach,
        nrows, bs);
    __syncthreads();
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

template <int NB, bool ONE_PASS>
int launch(const void* x, void* y, const void* wpack, const Dilations& dil,
           int G, int B, int T, int tile, int halo, void* stream) {
  if (G < 1 || G > MAX_G || B < 1 || T < 1 || tile < 1 || halo < 0)
    return cudaErrorInvalidValue;
  const int R = tile + halo;
  const size_t smem =
      ((size_t)(NB - 1) * window_floats(R) + (size_t)R * ROW_FLOATS) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      tcn_window_kernel<NB, ONE_PASS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + tile - 1) / tile, (B + NB - 1) / NB);
  tcn_window_kernel<NB, ONE_PASS><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, (const float*)wpack, dil, G, B, T, tile,
      halo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest window (tile + halo rows) one CTA can hold on `device`.
int tcn_max_window_rows(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin / (int)(ROW_FLOATS * sizeof(float));
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
