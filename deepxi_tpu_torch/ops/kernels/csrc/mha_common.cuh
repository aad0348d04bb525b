// Shared pieces of the MHANet kernels (mha_attention.cu: flash_attention
// and flash_attention_streaming; mha_block_fused.cu: the fused transformer
// block): widths, the masked attention kernel and its launch. float32
// throughout.
//
// The widths are compile-time constants given as defines (MHA_NH heads of
// MHA_DK); the wrappers build one library per set of widths (_build.py).
// They take a head width that is a multiple of 4 up to 64 (a thread holds a
// query row and its accumulator in registers) and up to 1024 columns.
//
// Attention follows the tfa convention of the reference:
//   logits = q.k + (-1e10) (1 - valid_q valid_k [causal])
// then a softmax over the keys the row visits, then the weighted values.
// The mask is additive in f32, never -inf: for a valid query row a masked
// key gives exp(-1e10 - max) = 0 exactly, and a fully masked (invalid) row
// adds -1e10 to every logit, which absorbs logits below ~512, so the row is
// in effect the mean of the values of the keys it visits. Which keys an
// invalid row visits is part of the function:
//   * n_keys (>= T) keys, those at or past T zero in k and v and invalid
//     (the key padding of the JAX kernels: Tp for the fused block, T rounded
//     up to 128 for flash_attention, to block_k for the streaming kernel);
//   * with skip_bq > 0 (causal streaming), only the key tiles of width
//     skip_bk up to the diagonal of the row's query tile of skip_bq rows.
// A valid row sees its own key, so its masked keys add exact zeros and it
// stops at its last unmasked key (r + 1 when causal, T otherwise).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

#if !defined(MHA_NH) || !defined(MHA_DK)
#error "build with -DMHA_NH=<heads> -DMHA_DK=<head width>"
#endif

constexpr int NH = MHA_NH;   // heads
constexpr int DK = MHA_DK;   // head width
constexpr int C = NH * DK;   // d_model
constexpr float NEG = -1.0e10f;
static_assert(NH >= 1 && DK % 4 == 0 && DK >= 4 && DK <= 64 && C <= 1024,
              "head widths a multiple of 4 up to 64, at most 1024 columns");

// attention tiles: one query row per thread, AQ rows a CTA; keys staged in
// shared memory AK at a time and folded into the running softmax KC at a time
constexpr int AQ = 64;
constexpr int AK = 64;
constexpr int KC = 16;
static_assert(AK % KC == 0 && DK % 4 == 0, "tile shapes");

struct AttnArgs {
  const float* q;      // [B, T, NH, DK], q pre-scaled
  const float* k;      // [B, T, NH, DK]
  const float* v;      // [B, T, NH, DK]
  const float* valid;  // [B, T], 1 or 0
  float* out;          // [B, T, NH, DK]
  int T;
  int n_keys;   // keys an invalid row visits without tile skipping (>= T)
  int causal;
  int skip_bq;  // > 0: the streaming kernel's causal key-tile skip
  int skip_bk;
};

// One past the last key an invalid (fully masked) row r visits.
__device__ __forceinline__ int invalid_row_end(const AttnArgs& a, int r) {
  if (a.causal && a.skip_bq > 0) {
    const int n_k = a.n_keys / a.skip_bk;
    const int last = min((r / a.skip_bq * a.skip_bq + a.skip_bq - 1) / a.skip_bk,
                         n_k - 1);
    return (last + 1) * a.skip_bk;
  }
  return a.n_keys;
}

// CTA (query tile blockIdx.x, head blockIdx.y, batch row blockIdx.z); thread
// t owns query row blockIdx.x * AQ + t with its q, accumulator, running max
// and denominator in registers. All threads stage each key tile (zeros past
// T) and each row folds in the keys below its own end.
__global__ void __launch_bounds__(AQ) mha_attention_kernel(AttnArgs a) {
  __shared__ __align__(16) float ks[AK][DK];
  __shared__ __align__(16) float vs[AK][DK];
  __shared__ float kval[AK];
  __shared__ int cta_end;

  const int h = blockIdx.y;
  const size_t base = (size_t)blockIdx.z * a.T;
  const int r = blockIdx.x * AQ + threadIdx.x;
  const bool live = r < a.T;

  float q[DK], acc[DK];
  bool row_valid = false;
  int end = 0;
  if (live) {
    const float4* qp = reinterpret_cast<const float4*>(a.q + ((base + r) * NH + h) * DK);
#pragma unroll
    for (int e = 0; e < DK / 4; ++e) {
      const float4 t = __ldg(qp + e);
      q[4 * e] = t.x;
      q[4 * e + 1] = t.y;
      q[4 * e + 2] = t.z;
      q[4 * e + 3] = t.w;
    }
    row_valid = a.valid[base + r] != 0.f;
    end = row_valid ? (a.causal ? r + 1 : a.T) : invalid_row_end(a, r);
  }
#pragma unroll
  for (int e = 0; e < DK; ++e) acc[e] = 0.f;
  float m = -1e30f, l = 0.f;

  if (threadIdx.x == 0) cta_end = 0;
  __syncthreads();
  atomicMax(&cta_end, end);
  __syncthreads();
  const int n_end = cta_end;

  for (int j0 = 0; j0 < n_end; j0 += AK) {
    for (int idx = threadIdx.x; idx < AK * DK / 4; idx += AQ) {
      const int jj = idx / (DK / 4), e4 = idx % (DK / 4);
      const int j = j0 + jj;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (j < a.T) {
        const size_t off = ((base + j) * NH + h) * (DK / 4) + e4;
        kk = __ldg(reinterpret_cast<const float4*>(a.k) + off);
        vv = __ldg(reinterpret_cast<const float4*>(a.v) + off);
      }
      reinterpret_cast<float4*>(ks[jj])[e4] = kk;
      reinterpret_cast<float4*>(vs[jj])[e4] = vv;
    }
    for (int jj = threadIdx.x; jj < AK; jj += AQ) {
      const int j = j0 + jj;
      kval[jj] = j < a.T ? a.valid[base + j] : 0.f;
    }
    __syncthreads();

    const int n_here = min(AK, end - j0);  // keys of this tile row r takes
    for (int c = 0; c < n_here; c += KC) {
      float s[KC];
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const int jj = c + u, j = j0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < DK; e += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[jj][e]);
          dot = fmaf(q[e], kk.x, dot);
          dot = fmaf(q[e + 1], kk.y, dot);
          dot = fmaf(q[e + 2], kk.z, dot);
          dot = fmaf(q[e + 3], kk.w, dot);
        }
        const bool allowed =
            row_valid && kval[jj] != 0.f && (!a.causal || j <= r);
        s[u] = jj < n_here ? (allowed ? dot : dot + NEG) : -INFINITY;
        cmax = fmaxf(cmax, s[u]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < DK; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < DK; e += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[c + u][e]);
          acc[e] = fmaf(p, vv.x, acc[e]);
          acc[e + 1] = fmaf(p, vv.y, acc[e + 1]);
          acc[e + 2] = fmaf(p, vv.z, acc[e + 2]);
          acc[e + 3] = fmaf(p, vv.w, acc[e + 3]);
        }
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (live) {
    const float inv = 1.f / l;
    float4* op = reinterpret_cast<float4*>(a.out + ((base + r) * NH + h) * DK);
#pragma unroll
    for (int e = 0; e < DK / 4; ++e)
      op[e] = make_float4(acc[4 * e] * inv, acc[4 * e + 1] * inv,
                          acc[4 * e + 2] * inv, acc[4 * e + 3] * inv);
  }
}

cudaError_t launch_attention(const AttnArgs& a, int B, cudaStream_t stream) {
  if (B < 1 || a.T < 1 || a.n_keys < a.T || B > 65535 ||
      (a.skip_bq > 0 && (a.skip_bk < 1 || a.n_keys % a.skip_bk != 0)))
    return cudaErrorInvalidValue;
  const dim3 grid((a.T + AQ - 1) / AQ, NH, B);
  mha_attention_kernel<<<grid, AQ, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
