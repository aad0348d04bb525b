// The fused MHANet transformer block for Hopper (sm_90a), float32
// throughout.
//
// Replaces deepxi_tpu/ops/kernels/mha_block_fused.py::fused_transformer_block,
// which runs one whole block per batch row with the [Tp, C] sequence in
// VMEM:
//   q, k, v = x Wq[h] * d_k^-1/2, x Wk[h], x Wv[h]     (H heads of d_k)
//   o = softmax(q k^T + (-1e10)(1 - valid_q valid_k [causal])) v
//   x1 = LN1(x + sum_h o[h] Wo[h])
//   out = LN2(x1 + relu(x1 W1 + b1) W2 + b2)
// with two-pass LayerNorms (eps 1e-6, scale and bias).
//
// A Hopper CTA has 227 KB of shared memory, so the sequence does not stay
// on chip: at mhanet-1.1c's widths (C 256, 8 heads of 32, DFF 1024) one
// [256, 256] f32 tile is 256 KB, and at Tp = 2048 one head's K and V are
// 512 KB. The block is three launches, which one call of mha_block_forward
// makes:
//   (a) mha_qkv_kernel<MS>: a CTA takes 16 MS rows by 128 of the 3 C
//       output columns (q, k, v side by side), written as [B, Tp, NH, DK];
//   (b) mha_attention_kernel (mha_common.cuh): one CTA per (query tile,
//       head, batch row) walking key tiles with an online softmax,
//       n_keys = Tp, so every row, padded ones included, is the full-row
//       softmax of the JAX kernel;
//   (c) mha_post_kernel<MS, NCL>: a thread block cluster of NCL CTAs takes
//       a slab of 16 MS rows. Each CTA computes C / NCL columns of o Wo and
//       the residual; the cluster exchanges them through distributed shared
//       memory so each CTA holds whole rows for LN1. Each CTA then takes
//       DFF / NCL of the FFN's intermediate columns, relu(x1 W1 + b1), and
//       their partial product with W2 over all C columns. The partials are
//       summed through distributed shared memory in rank order 0, 1, ...
//       (no atomics: the output is bitwise the same from run to run), each
//       CTA summing C / NCL columns and adding x1 and b2; then each CTA
//       gathers whole rows for its share of LN2. With NCL = 1 (many rows)
//       one CTA walks the whole FFN, DFF in chunks, as one slab.
//
// Products on the tensor cores: m16n8k8 TF32 mma.sync with operands split
// hi/lo to f32 accuracy (mma_tf32x3.cuh), two k-steps summed on the tensor
// cores and added in f32. The A operand (x, o, x1, an FFN chunk) sits in
// shared memory; the weights are staged 32 contraction rows at a time with
// cp.async, one (projections) or two (post kernel) stages in flight ahead
// of the one the warps multiply. The 8 warps cut a pass of 64 or 128
// columns over the CTA's rows (Tile).
//
// Launch shapes follow the row count (mha_block_forward): at B=1, Tp=256
// the projections take 96 CTAs of 16 rows and the rest 16 clusters of 8
// CTAs; at B=64, Tp=640 the projections 64-row CTAs (3,840) and the rest
// 640 single CTAs of 64 rows (each CTA reads all 2.4 MB of weights from L2
// once, so more rows a CTA read less).
//
// The widths: mha_common.cuh's heads, and the FFN width MHA_DFF, a
// multiple of C = NH * DK. Widths that 8 does not divide take zero-padded
// n-blocks (their columns are not stored) and zero-padded contraction rows.
//
// What bounds it on this card (mhanet-1.1c's widths): 1,572,864 product
// FLOP per row (the four projections and the FFN) plus 4 * 256 per (row,
// key), against 2 KB of activations in and out and 3.2 MB of weights per
// block, so operations: at B=64, T=625 one block is 75.7 GFLOP, 0.46 ms at
// the 165 TFLOP/s of f32-accurate tensor-core products (three dense TF32
// products, 495 TFLOP/s, for one). q, k, v and the attention output make
// one round trip through device memory (4 KB a row).

#include <cooperative_groups.h>

#include "deepxi_error.cuh"
#include "mha_common.cuh"

namespace {

namespace cg = cooperative_groups;

#ifndef MHA_DFF
#error "build with -DMHA_DFF=<FFN width>"
#endif

constexpr int DFF = MHA_DFF;   // FFN width
constexpr int NT = 256;        // threads of a row kernel
constexpr int NWARP = NT / 32;
constexpr int KC = 32;         // weight rows staged a time
constexpr int KG = 2;          // k-steps summed on the tensor cores a time
constexpr float LN_EPS = 1e-6f;
static_assert(DFF % C == 0 && DFF >= C, "the FFN width a multiple of C");

__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr int pad32(int n) { return (n + 31) / 32 * 32; }
// Row stride of an A tile in shared memory: its columns up to KC's
// multiple, 4 mod 32 floats so that a fragment's lanes (rows g, columns t)
// fall in distinct banks.
__host__ __device__ constexpr int a_ld(int k) { return pad32(k) + 4; }
// Row stride of a staged weight tile of 64 or 128 columns: 8 mod 32 (rows
// t, columns g).
__host__ __device__ constexpr int b_ld(int pw) { return pw + 8; }
constexpr int NBLK_C = pad8(C) / 8, NBLK_F = pad8(DFF) / 8;  // n-blocks of 8
constexpr int LDX = a_ld(C);
// floats of NS staging buffers of weight tiles up to 128 columns wide
__host__ __device__ constexpr int wbuf_floats(int ns) { return ns * KC * b_ld(128); }
constexpr int QKV_NS = 2, POST_NS = 3;  // stages in flight: ns - 1
constexpr int FCH = 128;  // FFN intermediate columns a CTA holds at a time (a pass)

// Elements of a C-wide row a warp lane holds (lane + 32 e), and whether
// element e of `lane` lies in the row (always, when 32 | C).
constexpr int LANE_C = (C + 31) / 32;
__device__ __forceinline__ bool in_row(int lane, int e) {
  return C % 32 == 0 || lane + 32 * e < C;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// How the 8 warps cut a pass of PW columns over 16 MS rows: WM warps down
// the rows (MSW slabs of 16 each), NWARP / WM across (NBW n-blocks of 8
// each). Two warps down the rows when the CTA has 32 rows or more: a warp
// splits each A fragment (its rows) for more n-blocks and each B fragment
// (its columns) for more slabs, fewer splits for the same products.
template <int MS, int PW>
struct Tile {
  static constexpr int WM = MS >= 2 && PW >= 128 ? 2 : 1;
  static constexpr int MSW = MS / WM, NBW = PW * WM / 64;
  static_assert(MSW * WM == MS && NBW * 8 * (NWARP / WM) == PW, "a pass the warps cover");
};

// acc = A[0, 16 MS) x [0, K) . B[0, K) x [0, ncols), on the tensor cores.
// A: shared memory, row stride lda; its columns from K up to KC's multiple
// must hold finite values (they meet zero weight rows). B: bsrc(k, c)
// points at the 4 floats of row k at columns c..c+3 (c % 4 == 0, c <
// ncols, ncols a multiple of 4 up to PW, 64 or 128), staged KC rows at a
// time into NS buffers of wbuf, NS - 1 stages in flight. Warp w takes rows
// 16 MSW wm.. and columns 8 NBW wn.. of the pass (wm = w / WN, wn = w % WN,
// Tile<MS, PW>): acc[m][nb] is the C fragment of its slab m and n-block nb.
// Ends with __syncthreads(), so the caller may overwrite A and reuse wbuf.
template <int NS, int MS, int PW, typename BSrc>
__device__ void row_product(const float* A, int lda, int K, BSrc bsrc, int ncols,
                            float* wbuf,
                            float (&acc)[Tile<MS, PW>::MSW][Tile<MS, PW>::NBW][4]) {
  using TL = Tile<MS, PW>;
  constexpr int MSW = TL::MSW, NBW = TL::NBW, WN = NWARP / TL::WM;
  constexpr int LDB = b_ld(PW), C4 = PW / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int nch = (K + KC - 1) / KC;
  const bool active = wn * 8 * NBW < ncols;
  auto stage = [&](int ch) {
    if (ch < nch) {
      float* dst = wbuf + ch % NS * KC * LDB;
      for (int idx = threadIdx.x; idx < KC * C4; idx += NT) {
        const int kk = idx / C4, c = 4 * (idx % C4), k = ch * KC + kk;
        const bool in = k < K && c < ncols;
        cp_async16(dst + kk * LDB + c, in ? bsrc(k, c) : bsrc(0, 0), !in);
      }
    }
    cp_async_commit();  // empty past the last stage: the waits count the same
  };
#pragma unroll
  for (int m = 0; m < MSW; ++m) zero(acc[m]);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) stage(s);
  const float* Aw = A + (16 * MSW * wm + g) * lda + t;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<NS - 2>();  // stage ch has landed
    __syncthreads();          // ... for every thread; stage ch - 1 is consumed
    stage(ch + NS - 1);
    if (active) {
      const float* wb = wbuf + ch % NS * KC * LDB + wn * 8 * NBW + g;
#pragma unroll
      for (int s0 = 0; s0 < KC / 8; s0 += KG) {
        float p[MSW][NBW][4];
#pragma unroll
        for (int m = 0; m < MSW; ++m) zero(p[m]);
#pragma unroll
        for (int s = s0; s < s0 + KG; ++s) {
          FragB b[NBW];
#pragma unroll
          for (int nb = 0; nb < NBW; ++nb)
            set_b(b[nb], wb[(8 * s + t) * LDB + 8 * nb],
                  wb[(8 * s + t + 4) * LDB + 8 * nb]);
#pragma unroll
          for (int m = 0; m < MSW; ++m) {
            const float* a = Aw + 16 * m * lda + ch * KC + 8 * s;
            FragA fa;
            set_a(fa, a[0], a[8 * lda], a[4], a[8 * lda + 4]);
            mma_tf32x3(p[m], fa, b);
          }
        }
#pragma unroll
        for (int m = 0; m < MSW; ++m) add_to(acc[m], p[m]);
      }
    }
  }
  __syncthreads();
}

// f(row, col, v0, v1): the pairs (col, col + 1) of row_product<., MS, PW>'s
// output with col < ncols (ncols even, so col + 1 < ncols too).
template <int MS, int PW, typename F>
__device__ __forceinline__ void for_pairs(
    const float (&acc)[Tile<MS, PW>::MSW][Tile<MS, PW>::NBW][4], int ncols, F f) {
  using TL = Tile<MS, PW>;
  constexpr int WN = NWARP / TL::WM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
#pragma unroll
  for (int m = 0; m < TL::MSW; ++m)
#pragma unroll
    for (int nb = 0; nb < TL::NBW; ++nb) {
      const int col = 8 * (TL::NBW * wn + nb) + 2 * t;
      if (col >= ncols) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        f(16 * (TL::MSW * wm + m) + g + 8 * i, col, acc[m][nb][2 * i],
          acc[m][nb][2 * i + 1]);
    }
}

// Rows row0 .. row0 + rows - 1 of a [n_rows, C] tensor into a shared tile
// of row stride ld (zeros past n_rows and in columns C .. ld).
__device__ void load_rows(const float* __restrict__ src, float* dst, int ld,
                          int row0, int rows, int n_rows) {
  constexpr int C4 = C / 4;
  for (int idx = threadIdx.x; idx < rows * C4; idx += NT) {
    const int r = idx / C4, c4 = idx % C4;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * ld + 4 * c4, in ? src + (size_t)(row0 + r) * C + 4 * c4 : src,
               !in);
  }
  cp_async_commit();
  const int pad4 = (ld - C) / 4;
  for (int idx = threadIdx.x; idx < rows * pad4; idx += NT)
    reinterpret_cast<float4*>(dst + (idx / pad4) * ld + C)[idx % pad4] =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// dst[c] = LN(src[c]) * scale[c] + bias[c] over one C-wide row, by one
// warp (two-pass variance, as the JAX kernel's _ln); src and dst may be
// the same row.
__device__ void ln_row(const float* src, float* dst,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  float v[LANE_C];
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < LANE_C; ++e) {
    v[e] = in_row(lane, e) ? src[lane + 32 * e] : 0.f;
    s += v[e];
  }
  const float mu = warp_sum(s) * (1.f / C);
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < LANE_C; ++e) {
    const float t = in_row(lane, e) ? v[e] - mu : 0.f;
    q += t * t;
  }
  const float rs = rsqrtf(warp_sum(q) * (1.f / C) + LN_EPS);
#pragma unroll
  for (int e = 0; e < LANE_C; ++e) {
    if (!in_row(lane, e)) continue;
    const int c = lane + 32 * e;
    dst[c] = (v[e] - mu) * rs * __ldg(scale + c) + __ldg(bias + c);
  }
}

// (a) q (scaled), k, v of rows [16 MS blockIdx.x, + 16 MS) and output
// columns [128 blockIdx.y, + 128) of the 3 C: column j is projection j / C,
// head (j % C) / DK, dim j % DK; the kernels are [NH, C, DK].
template <int MS>
constexpr size_t qkv_smem() {
  return (size_t)(16 * MS * LDX + wbuf_floats(QKV_NS)) * sizeof(float);
}

template <int MS>
__global__ void __launch_bounds__(NT)
mha_qkv_kernel(const float* __restrict__ x, const float* __restrict__ wq,
               const float* __restrict__ wk, const float* __restrict__ wv,
               float* __restrict__ q, float* __restrict__ k,
               float* __restrict__ v, int n_rows, float scale) {
  constexpr int RT = 16 * MS;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [RT][LDX]
  float* wbuf = xs + RT * LDX;
  const int row0 = blockIdx.x * RT, col0 = blockIdx.y * 128;
  load_rows(x, xs, LDX, row0, RT, n_rows);
  const int ncols = min(128, 3 * C - col0);
  auto bsrc = [=](int kk, int c) -> const float* {
    const int j = col0 + c, p = j / C, cc = j % C;
    const float* W = p == 0 ? wq : p == 1 ? wk : wv;
    return W + ((size_t)(cc / DK) * C + kk) * DK + cc % DK;
  };
  using TL = Tile<MS, 128>;
  float acc[TL::MSW][TL::NBW][4];
  row_product<QKV_NS, MS, 128>(xs, LDX, C, bsrc, ncols, wbuf, acc);
  for_pairs<MS, 128>(acc, ncols, [&](int r, int col, float v0, float v1) {
    if (row0 + r >= n_rows) return;
    const int j = col0 + col, p = j / C, cc = j % C;
    float* O = p == 0 ? q : p == 1 ? k : v;
    const float s = p == 0 ? scale : 1.f;
    *reinterpret_cast<float2*>(O + (size_t)(row0 + r) * C + cc) =
        make_float2(v0 * s, v1 * s);
  });
}

struct PostWeights {
  const float* wo;  // [NH, DK, C] = [C, C] row-major
  const float* ln1_s;
  const float* ln1_b;
  const float* ff1_w;  // [C, DFF]
  const float* ff1_b;
  const float* ff2_w;  // [DFF, C]
  const float* ff2_b;
  const float* ln2_s;
  const float* ln2_b;
};

template <int MS>
constexpr size_t post_smem() {
  return (size_t)(16 * MS * (2 * LDX + a_ld(FCH)) + wbuf_floats(POST_NS)) * sizeof(float);
}

// Columns [8 nb0, 8 nb1) of `nblk` n-blocks split NCL ways: rank r's share,
// cut at `width`.
__device__ __forceinline__ int share(int r, int ncl, int nblk, int width) {
  return min(r * nblk / ncl * 8, width);
}

// (c) out = LN2(x1 + relu(x1 W1 + b1) W2 + b2), x1 = LN1(x + o Wo), for the
// 16 MS rows of slab blockIdx.x / NCL; cluster rank r of NCL takes columns
// [share(r), share(r + 1)) of o Wo and of the summed output, DFF columns
// [share(r), share(r + 1)) of the FFN, and rows r, r + NCL, ... of LN2.
template <int MS, int NCL>
__global__ void __launch_bounds__(NT, 1)
mha_post_kernel(const float* __restrict__ x, const float* __restrict__ o,
                PostWeights w, float* __restrict__ out, int n_rows) {
  constexpr int RT = 16 * MS, LDU = a_ld(FCH);
  // o Wo's columns a CTA takes: one pass of 64 (NBW 1) or passes of 128
  constexpr int PW_A = NBLK_C / NCL * 8 >= 128 ? 128 : 64;
  using TA = Tile<MS, PW_A>;
  using TF = Tile<MS, FCH>;  // an FFN chunk is one pass
  using T2 = Tile<MS, 128>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [RT][LDX]: x, x + o Wo, x1, z
  float* zs = xs + RT * LDX;   // [RT][LDX]: o, then the FFN's W2 product summed
  float* us = zs + RT * LDX;   // [RT][LDU]: an FFN chunk, relu(x1 W1 + b1)
  float* wbuf = us + RT * LDU;
  const int rank = NCL > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int row0 = blockIdx.x / NCL * RT;
  const int warp = threadIdx.x >> 5;

  for (int idx = threadIdx.x; idx < RT * LDU / 4; idx += NT)
    reinterpret_cast<float4*>(us)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  load_rows(o, zs, LDX, row0, RT, n_rows);
  load_rows(x, xs, LDX, row0, RT, n_rows);

  // x + o Wo on this CTA's columns
  const int a0 = share(rank, NCL, NBLK_C, C), a1 = share(rank + 1, NCL, NBLK_C, C);
  for (int c0 = a0; c0 < a1; c0 += PW_A) {
    const int nc = min(PW_A, a1 - c0);
    float acc[TA::MSW][TA::NBW][4];
    row_product<POST_NS, MS, PW_A>(
        zs, LDX, C, [=](int k, int c) { return w.wo + (size_t)k * C + c0 + c; }, nc,
        wbuf, acc);
    for_pairs<MS, PW_A>(acc, nc, [&](int r, int col, float v0, float v1) {
      float2* p = reinterpret_cast<float2*>(xs + r * LDX + c0 + col);
      const float2 xv = *p;
      *p = make_float2(xv.x + v0, xv.y + v1);
    });
  }
  cp_async_wait<0>();  // the loads, when this rank has no columns of o Wo
  if constexpr (NCL > 1) {
    // whole rows of x + o Wo from the other ranks' columns
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    for (int q = 0; q < NCL; ++q) {
      if (q == rank) continue;
      const float* rx = cl.map_shared_rank(xs, q);
      const int q0 = share(q, NCL, NBLK_C, C), w4 = (share(q + 1, NCL, NBLK_C, C) - q0) / 4;
      for (int idx = threadIdx.x; idx < RT * w4; idx += NT) {
        const int off = (idx / w4) * LDX + q0 + 4 * (idx % w4);
        *reinterpret_cast<float4*>(xs + off) = *reinterpret_cast<const float4*>(rx + off);
      }
    }
    cl.sync();  // no rank overwrites its rows while another reads them
  } else {
    __syncthreads();
  }
  for (int r = warp; r < RT; r += NWARP) ln_row(xs + r * LDX, xs + r * LDX, w.ln1_s, w.ln1_b);
  for (int idx = threadIdx.x; idx < RT * C / 4; idx += NT)
    reinterpret_cast<float4*>(zs + idx / (C / 4) * LDX)[idx % (C / 4)] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the FFN on DFF columns [f0, f1), FCH at a time: us = relu(x1 W1 + b1),
  // zs += us W2 (summed over the chunks in order, in f32)
  const int f0 = share(rank, NCL, NBLK_F, DFF), f1 = share(rank + 1, NCL, NBLK_F, DFF);
  for (int fc = f0; fc < f1; fc += FCH) {
    const int fw = min(FCH, f1 - fc);
    {
      float acc[TF::MSW][TF::NBW][4];
      row_product<POST_NS, MS, FCH>(
          xs, LDX, C, [=](int k, int c) { return w.ff1_w + (size_t)k * DFF + fc + c; },
          fw, wbuf, acc);
      for_pairs<MS, FCH>(acc, FCH, [&](int r, int col, float v0, float v1) {
        const float2 b = col < fw ? __ldg(reinterpret_cast<const float2*>(w.ff1_b + fc + col))
                                  : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(us + r * LDU + col) =
            col < fw ? make_float2(fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f))
                     : make_float2(0.f, 0.f);
      });
    }
    for (int c0 = 0; c0 < C; c0 += 128) {
      const int nc = min(128, C - c0);
      float acc[T2::MSW][T2::NBW][4];
      row_product<POST_NS, MS, 128>(
          us, LDU, fw,
          [=](int k, int c) { return w.ff2_w + (size_t)(fc + k) * C + c0 + c; }, nc,
          wbuf, acc);
      for_pairs<MS, 128>(acc, nc, [&](int r, int col, float v0, float v1) {
        float2* p = reinterpret_cast<float2*>(zs + r * LDX + c0 + col);
        const float2 z = *p;
        *p = make_float2(z.x + v0, z.y + v1);
      });
    }
  }

  // z = x1 + (the W2 products summed) + b2, then LN2
  if constexpr (NCL > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every rank's partial is in its zs
    const int w4 = (a1 - a0) / 4;
    for (int idx = threadIdx.x; idx < RT * w4; idx += NT) {
      const int off = (idx / w4) * LDX + a0 + 4 * (idx % w4);
      float4 s = *reinterpret_cast<const float4*>(cl.map_shared_rank(zs, 0) + off);
      for (int q = 1; q < NCL; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(cl.map_shared_rank(zs, q) + off);
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
      const float4 b = __ldg(reinterpret_cast<const float4*>(w.ff2_b + a0) + idx % w4);
      float4* xp = reinterpret_cast<float4*>(xs + off);
      const float4 x1 = *xp;
      *xp = make_float4(x1.x + s.x + b.x, x1.y + s.y + b.y, x1.z + s.z + b.z,
                        x1.w + s.w + b.w);
    }
    cl.sync();  // z of every column range is in its rank's xs
    // this rank's rows: the other ranks' columns of z into xs
    for (int q = 0; q < NCL; ++q) {
      if (q == rank) continue;
      const float* rx = cl.map_shared_rank(xs, q);
      const int q0 = share(q, NCL, NBLK_C, C), w4q = (share(q + 1, NCL, NBLK_C, C) - q0) / 4;
      const int my_rows = (RT - rank + NCL - 1) / NCL;
      for (int idx = threadIdx.x; idx < my_rows * w4q; idx += NT) {
        const int off = (rank + NCL * (idx / w4q)) * LDX + q0 + 4 * (idx % w4q);
        *reinterpret_cast<float4*>(xs + off) = *reinterpret_cast<const float4*>(rx + off);
      }
    }
    __syncthreads();
    for (int r = rank + NCL * warp; r < RT; r += NCL * NWARP)
      if (row0 + r < n_rows)
        ln_row(xs + r * LDX, out + (size_t)(row0 + r) * C, w.ln2_s, w.ln2_b);
    cl.sync();  // no rank leaves while another reads its shared memory
  } else {
    for (int idx = threadIdx.x; idx < RT * C / 4; idx += NT) {
      const int off = idx / (C / 4) * LDX + 4 * (idx % (C / 4));
      const float4 s = *reinterpret_cast<const float4*>(zs + off);
      const float4 b = __ldg(reinterpret_cast<const float4*>(w.ff2_b) + idx % (C / 4));
      float4* xp = reinterpret_cast<float4*>(xs + off);
      const float4 x1 = *xp;
      *xp = make_float4(x1.x + s.x + b.x, x1.y + s.y + b.y, x1.z + s.z + b.z,
                        x1.w + s.w + b.w);
    }
    __syncthreads();
    for (int r = warp; r < RT; r += NWARP)
      if (row0 + r < n_rows)
        ln_row(xs + r * LDX, out + (size_t)(row0 + r) * C, w.ln2_s, w.ln2_b);
  }
}

// Rows a CTA of the many-row shapes takes: the projections as many as fit
// two CTAs an SM, the post kernel as many as fit one (each CTA reads all of
// Wo, W1 and W2 from L2 once, so more rows a CTA read fewer weight bytes).
constexpr size_t HALF_SM = 232448 / 2 - 1024, FULL_SM = 232448;
constexpr int QKV_MS_LARGE = qkv_smem<4>() <= HALF_SM ? 4 : qkv_smem<2>() <= HALF_SM ? 2 : 1;
constexpr int POST_MS_LARGE = post_smem<4>() <= FULL_SM ? 4 : post_smem<2>() <= FULL_SM ? 2 : 1;
// Cluster size of the few-row shapes: up to 8, no more than C's n-blocks.
constexpr int NCL_SMALL = NBLK_C >= 8 ? 8 : NBLK_C >= 4 ? 4 : NBLK_C >= 2 ? 2 : 1;

// The launch shapes for n_rows rows on n_sm SMs: {qkv rows a CTA, qkv
// CTAs, post rows a cluster, post cluster size, post CTAs}.
struct Shape {
  int qkv_ms, qkv_ctas, post_ms, ncl, post_ctas;
};

Shape shape_for(int n_rows, int n_sm) {
  const int col_tiles = (3 * C + 127) / 128;
  Shape s{};
  const int big_tiles = (n_rows + 16 * QKV_MS_LARGE - 1) / (16 * QKV_MS_LARGE);
  s.qkv_ms = (long)big_tiles * col_tiles >= 2L * n_sm ? QKV_MS_LARGE : 1;
  s.qkv_ctas = (n_rows + 16 * s.qkv_ms - 1) / (16 * s.qkv_ms) * col_tiles;
  const int big_slabs = (n_rows + 16 * POST_MS_LARGE - 1) / (16 * POST_MS_LARGE);
  if (big_slabs >= n_sm) {
    s.post_ms = POST_MS_LARGE;
    s.ncl = 1;
  } else {
    s.post_ms = 1;
    s.ncl = NCL_SMALL;
  }
  s.post_ctas = (n_rows + 16 * s.post_ms - 1) / (16 * s.post_ms) * s.ncl;
  return s;
}

template <int MS>
cudaError_t launch_qkv(const float* x, const float* wq, const float* wk,
                       const float* wv, float* q, float* k, float* v,
                       int n_rows, float scale, cudaStream_t s) {
  static bool ready = false;  // the shared-memory opt-in, once a process
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_qkv_kernel<MS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)qkv_smem<MS>());
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const dim3 grid((n_rows + 16 * MS - 1) / (16 * MS), (3 * C + 127) / 128);
  mha_qkv_kernel<MS><<<grid, NT, qkv_smem<MS>(), s>>>(x, wq, wk, wv, q, k, v,
                                                        n_rows, scale);
  return cudaGetLastError();
}

template <int MS, int NCL>
cudaError_t launch_post(const float* x, const float* o, const PostWeights& w,
                        float* out, int n_rows, cudaStream_t s) {
  constexpr size_t smem = post_smem<MS>();
  static bool ready = false;  // the shared-memory opt-in, once a process
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_post_kernel<MS, NCL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rows + 16 * MS - 1) / (16 * MS) * NCL);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = NCL > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mha_post_kernel<MS, NCL>, x, o, w, out,
                                           n_rows);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch shapes mha_block_forward takes for B x T rows, into out[5]:
// rows a CTA and CTAs of the projections, rows a slab, cluster size and
// CTAs of the post kernel.
int mha_block_grid(int B, int T, int* out) {
  if (B < 1 || T < 1) return cudaErrorInvalidValue;
  const int n_sm = sm_count();
  if (n_sm == 0) return cudaErrorUnknown;
  const Shape s = shape_for(B * T, n_sm);
  out[0] = 16 * s.qkv_ms;
  out[1] = s.qkv_ctas;
  out[2] = 16 * s.post_ms;
  out[3] = s.ncl;
  out[4] = s.post_ctas;
  return 0;
}

// One transformer block over x [B, T, C] -> out (not in place); valid
// [B, T] is 1 or 0; q, k, v, o are [B, T, C] scratch the caller
// allocates. Weights in the JAX layouts: wq/wk/wv [NH, C, DK], wo
// [NH, DK, C], ff1_w [C, DFF], ff2_w [DFF, C]; scale = DK^-1/2.
int mha_block_forward(const void* x, const void* valid, const void* wq,
                      const void* wk, const void* wv, const void* wo,
                      const void* ln1_s, const void* ln1_b, const void* ff1_w,
                      const void* ff1_b, const void* ff2_w, const void* ff2_b,
                      const void* ln2_s, const void* ln2_b, void* q, void* k,
                      void* v, void* o, void* out, int B, int T, int causal,
                      float scale, void* stream) {
  if (B < 1 || T < 1) return cudaErrorInvalidValue;
  const int n_sm = sm_count();
  if (n_sm == 0) return cudaErrorUnknown;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_rows = B * T;
  const Shape sh = shape_for(n_rows, n_sm);
  const float *xf = (const float*)x, *wqf = (const float*)wq,
              *wkf = (const float*)wk, *wvf = (const float*)wv;
  cudaError_t e =
      sh.qkv_ms == 1
          ? launch_qkv<1>(xf, wqf, wkf, wvf, (float*)q, (float*)k, (float*)v, n_rows, scale, s)
          : launch_qkv<QKV_MS_LARGE>(xf, wqf, wkf, wvf, (float*)q, (float*)k, (float*)v,
                                     n_rows, scale, s);
  if (e != cudaSuccess) return e;
  AttnArgs a{(const float*)q, (const float*)k, (const float*)v,
             valid, (float*)o, T, T, causal, 0, 0};
  e = launch_attention<float>(a, B, s);
  if (e != cudaSuccess) return e;
  PostWeights w{(const float*)wo,    (const float*)ln1_s, (const float*)ln1_b,
                (const float*)ff1_w, (const float*)ff1_b, (const float*)ff2_w,
                (const float*)ff2_b, (const float*)ln2_s, (const float*)ln2_b};
  return sh.ncl == 1 && sh.post_ms == POST_MS_LARGE
             ? launch_post<POST_MS_LARGE, 1>(xf, (const float*)o, w, (float*)out, n_rows, s)
             : launch_post<1, NCL_SMALL>(xf, (const float*)o, w, (float*)out, n_rows, s);
}

}  // extern "C"
