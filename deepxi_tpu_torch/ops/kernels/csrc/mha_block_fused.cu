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
//   (a) mha_qkv_kernel: R rows a CTA, q, k, v written as [B, Tp, NH, DK];
//   (b) mha_attention_kernel (mha_common.cuh): one CTA per (query tile,
//       head, batch row) walking key tiles with an online softmax, its
//       products on the tensor cores to f32 accuracy, n_keys = Tp (valid
//       read as the floats this entry takes), so every row, padded ones
//       included, is the full-row softmax of the JAX kernel;
//   (c) mha_post_kernel: R rows a CTA, the output projection, residual,
//       LN1, the FFN with its [R, DFF] intermediate kept on chip a C-wide
//       chunk at a time (the second product accumulates in registers across
//       the chunks), residual and LN2.
// A thread owns 4 columns of 8 rows, so R = 8 * 256 / (C / 4): 32 rows at
// C 256, 256 at C 32.
//
// The widths: mha_common.cuh's heads, and the FFN width MHA_DFF, a multiple
// of C = NH * DK (the products walk it C columns at a time).
//
// What bounds it on this card (mhanet-1.1c's widths): 1,572,864 product
// FLOP per row (the four projections and the FFN) plus 4 * 256 per (row,
// key), against 2 KB of activations in and out and 3.2 MB of weights per
// block, so operations: at B=64, T=625 one block is 75.7 GFLOP, 1.13 ms at
// the 67 TFLOP/s f32 CUDA-core peak. Products are register-tiled FMA loops
// (8 rows x 4 columns a thread, the row tile in shared memory, weights as
// float4 read-only loads through L1/L2); q, k, v and the attention output
// make one round trip through device memory (4 KB a row).

#include "mha_common.cuh"

namespace {

#ifndef MHA_DFF
#error "build with -DMHA_DFF=<FFN width>"
#endif

constexpr int DFF = MHA_DFF;   // FFN width
constexpr int NT = 256;        // threads of a row kernel
constexpr int TN = C / 4;      // threads across a C-column chunk, 4 columns each
constexpr int TRW = NT / TN;   // thread rows; threads past TRW * TN idle in products
constexpr int RM = 8;          // rows a thread: tr, tr + TRW, ...
constexpr int R = TRW * RM;    // rows a CTA
constexpr float LN_EPS = 1e-6f;
static_assert(DFF % C == 0 && DFF >= C, "the FFN width a multiple of C");

// Elements of a C-wide row a warp lane holds (lane + 32 e), and whether
// element e of `lane` lies in the row (always, when 32 | C).
constexpr int LANE_C = (C + 31) / 32;
__device__ __forceinline__ bool in_row(int lane, int e) {
  return C % 32 == 0 || lane + 32 * e < C;
}

// Whether this thread takes part in the products.
__device__ __forceinline__ bool product_thread() {
  return NT % TN == 0 || threadIdx.x < TN * TRW;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][c] += sum_{k < C} A[tr + TRW i][k] W[k][c] over the thread's 4
// columns c: A is a shared [R, C] tile, Wt points at the thread's first
// column in row k = 0 of W, and ws is the distance between rows of W.
__device__ __forceinline__ void product(const float* A,
                                        const float* __restrict__ Wt, int ws,
                                        float (&acc)[RM][4]) {
  const float* Ar = A + (threadIdx.x / TN) * C;
#pragma unroll 2
  for (int k = 0; k < C; k += 4) {
    float4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w[u] = __ldg(reinterpret_cast<const float4*>(Wt + (size_t)(k + u) * ws));
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(Ar + i * TRW * C + k);
      acc[i][0] = fmaf(a.x, w[0].x, acc[i][0]);
      acc[i][1] = fmaf(a.x, w[0].y, acc[i][1]);
      acc[i][2] = fmaf(a.x, w[0].z, acc[i][2]);
      acc[i][3] = fmaf(a.x, w[0].w, acc[i][3]);
      acc[i][0] = fmaf(a.y, w[1].x, acc[i][0]);
      acc[i][1] = fmaf(a.y, w[1].y, acc[i][1]);
      acc[i][2] = fmaf(a.y, w[1].z, acc[i][2]);
      acc[i][3] = fmaf(a.y, w[1].w, acc[i][3]);
      acc[i][0] = fmaf(a.z, w[2].x, acc[i][0]);
      acc[i][1] = fmaf(a.z, w[2].y, acc[i][1]);
      acc[i][2] = fmaf(a.z, w[2].z, acc[i][2]);
      acc[i][3] = fmaf(a.z, w[2].w, acc[i][3]);
      acc[i][0] = fmaf(a.w, w[3].x, acc[i][0]);
      acc[i][1] = fmaf(a.w, w[3].y, acc[i][1]);
      acc[i][2] = fmaf(a.w, w[3].z, acc[i][2]);
      acc[i][3] = fmaf(a.w, w[3].w, acc[i][3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[RM][4]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

// Rows row0 .. row0 + R - 1 of a [n_rows, C] tensor into a shared tile
// (zeros past n_rows).
__device__ void load_rows(const float* __restrict__ src, float* dst, int row0,
                          int n_rows) {
  for (int idx = threadIdx.x; idx < R * C / 4; idx += NT) {
    const int r = idx / (C / 4), c4 = idx % (C / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      v = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * C) + c4);
    reinterpret_cast<float4*>(dst + r * C)[c4] = v;
  }
}

// dst[r] = LN(src[r]) * scale + bias for rows r < n (two-pass variance, as
// the JAX kernel's _ln); one warp a row, src and dst may be the same rows.
__device__ void layer_norm_rows(const float* src, float* dst,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += NT / 32) {
    float v[LANE_C];
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < LANE_C; ++e) {
      v[e] = in_row(lane, e) ? src[r * C + lane + 32 * e] : 0.f;
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
      dst[(size_t)r * C + c] = (v[e] - mu) * rs * __ldg(scale + c) + __ldg(bias + c);
    }
  }
}

// (a) q (scaled), k, v of rows [row0, row0 + R) from x; the projection
// kernels are [NH, C, DK], so the thread's columns 4tc..4tc+3 lie in head
// tc / 8 at offset 4 (tc % 8).
__global__ void __launch_bounds__(NT)
mha_qkv_kernel(const float* __restrict__ x, const float* __restrict__ wq,
               const float* __restrict__ wk, const float* __restrict__ wv,
               float* __restrict__ q, float* __restrict__ k,
               float* __restrict__ v, int n_rows, float scale) {
  __shared__ __align__(16) float xs[R * C];
  const int row0 = blockIdx.x * R;
  load_rows(x, xs, row0, n_rows);
  __syncthreads();
  if (!product_thread()) return;
  const int tc = threadIdx.x % TN, tr = threadIdx.x / TN;
  const size_t woff = (size_t)(tc / (DK / 4)) * C * DK + 4 * (tc % (DK / 4));
  const float* const W[3] = {wq, wk, wv};
  float* const O[3] = {q, k, v};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float acc[RM][4];
    zero(acc);
    product(xs, W[p] + woff, DK, acc);
    const float s = p == 0 ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = row0 + tr + TRW * i;
      if (r < n_rows)
        reinterpret_cast<float4*>(O[p] + (size_t)r * C)[tc] =
            make_float4(acc[i][0] * s, acc[i][1] * s, acc[i][2] * s, acc[i][3] * s);
    }
  }
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

constexpr size_t POST_SMEM = 2 * R * C * sizeof(float);

// (c) out = LN2(x1 + relu(x1 W1 + b1) W2 + b2), x1 = LN1(x + o Wo), for rows
// [row0, row0 + R).
__global__ void __launch_bounds__(NT)
mha_post_kernel(const float* __restrict__ x, const float* __restrict__ o,
                PostWeights w, float* __restrict__ out, int n_rows) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // x, x + att, x1
  float* as = xs + R * C;                       // o, FFN chunks, x1 + f2 + b2
  const int row0 = blockIdx.x * R;
  const int tc = threadIdx.x % TN, tr = threadIdx.x / TN;
  const bool pt = product_thread();
  load_rows(o, as, row0, n_rows);
  load_rows(x, xs, row0, n_rows);
  __syncthreads();
  if (pt) {
    float acc[RM][4];
    zero(acc);
    product(as, w.wo + 4 * tc, C, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float4* p = reinterpret_cast<float4*>(xs + (tr + TRW * i) * C) + tc;
      float4 t = *p;
      t.x += acc[i][0];
      t.y += acc[i][1];
      t.z += acc[i][2];
      t.w += acc[i][3];
      *p = t;
    }
  }
  __syncthreads();
  layer_norm_rows(xs, xs, w.ln1_s, w.ln1_b, R);
  __syncthreads();

  float acc2[RM][4];
  zero(acc2);
  for (int ch = 0; ch < DFF / C; ++ch) {
    if (pt) {
      float acc1[RM][4];
      zero(acc1);
      product(xs, w.ff1_w + ch * C + 4 * tc, DFF, acc1);
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(w.ff1_b + ch * C) + tc);
#pragma unroll
      for (int i = 0; i < RM; ++i)
        reinterpret_cast<float4*>(as + (tr + TRW * i) * C)[tc] = make_float4(
            fmaxf(acc1[i][0] + b1.x, 0.f), fmaxf(acc1[i][1] + b1.y, 0.f),
            fmaxf(acc1[i][2] + b1.z, 0.f), fmaxf(acc1[i][3] + b1.w, 0.f));
    }
    __syncthreads();
    if (pt) product(as, w.ff2_w + (size_t)ch * C * C + 4 * tc, C, acc2);
    __syncthreads();
  }
  if (pt) {
    const float4 b2 = __ldg(reinterpret_cast<const float4*>(w.ff2_b) + tc);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = (tr + TRW * i) * C;
      const float4 x1 = reinterpret_cast<const float4*>(xs + r)[tc];
      reinterpret_cast<float4*>(as + r)[tc] =
          make_float4(x1.x + acc2[i][0] + b2.x, x1.y + acc2[i][1] + b2.y,
                      x1.z + acc2[i][2] + b2.z, x1.w + acc2[i][3] + b2.w);
    }
  }
  __syncthreads();
  layer_norm_rows(as, out + (size_t)row0 * C, w.ln2_s, w.ln2_b,
                  min(R, n_rows - row0));
}

}  // namespace

extern "C" {

const char* mha_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
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
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_rows = B * T, n_tiles = (n_rows + R - 1) / R;
  mha_qkv_kernel<<<n_tiles, NT, 0, s>>>(
      (const float*)x, (const float*)wq, (const float*)wk, (const float*)wv,
      (float*)q, (float*)k, (float*)v, n_rows, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  AttnArgs a{(const float*)q, (const float*)k, (const float*)v,
             valid, (float*)o, T, T, causal, 0, 0};
  e = launch_attention<float>(a, B, s);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(mha_post_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)POST_SMEM);
  if (e != cudaSuccess) return e;
  PostWeights w{(const float*)wo,    (const float*)ln1_s, (const float*)ln1_b,
                (const float*)ff1_w, (const float*)ff1_b, (const float*)ff2_w,
                (const float*)ff2_b, (const float*)ln2_s, (const float*)ln2_b};
  mha_post_kernel<<<n_tiles, NT, POST_SMEM, s>>>((const float*)x,
                                                 (const float*)o, w,
                                                 (float*)out, n_rows);
  return cudaGetLastError();
}

}  // extern "C"
