// Shared pieces of the MHANet kernels (mha_attention.cu: flash_attention
// and flash_attention_streaming; mha_block_fused.cu: the fused transformer
// block): widths, the masked attention kernel and its launch. f32 values,
// products on the tensor cores to f32 accuracy (mma_tf32x3.cuh).
//
// The widths are compile-time constants given as defines (MHA_NH heads of
// MHA_DK); the wrappers build one library per set of widths (_build.py).
// They take a head width that is a multiple of 4 up to 64 and up to 1024
// columns; a width that 8 does not divide runs on tiles zero-padded to the
// next multiple of 8 in shared memory (the m16n8k8 product's k and n).
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
// stops at its last unmasked key (r + 1 when causal, T otherwise). Keys past
// a row's end take -inf (they are not in its softmax at all).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

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

// Attention tiles. A warp owns a slab of 16 query rows (the m16n8k8 tile's
// m); a CTA of AW warps holds QW slabs and splits each slab's keys KW =
// AW / QW ways. Keys are staged AK at a time, double-buffered with cp.async,
// in rows of LDK floats (DKP, the head width padded with zeros to a
// multiple of 8, plus 4: the fragment loads then fall in distinct banks).
constexpr int AW = 4;
constexpr int AT = 32 * AW;
constexpr int SLAB = 16;
constexpr int AK = 64;
constexpr int DKP = (DK + 7) / 8 * 8;
constexpr int LDK = DKP + 4;
constexpr int KSTEPS = DKP / 8;  // k-steps of q.k, n-blocks of the output
constexpr size_t ATTN_SMEM = (size_t)2 * 2 * AK * LDK * sizeof(float)
                             + 2 * AK * sizeof(float);

struct AttnArgs {
  const float* q;      // [B, T, NH, DK], q pre-scaled
  const float* k;      // [B, T, NH, DK]
  const float* v;      // [B, T, NH, DK]
  const void* valid;   // [B, T], 0 or not: uint8 (bool) or float
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

// A query row of a thread's fragments: its index, validity and end.
struct QueryRow {
  int r;
  bool valid;
  int end;  // one past the last key it visits; 0 past T
};

template <typename VT>
__device__ __forceinline__ QueryRow query_row(const AttnArgs& a, size_t base,
                                              int r) {
  QueryRow q{r, false, 0};
  if (r < a.T) {
    q.valid = static_cast<const VT*>(a.valid)[base + r] != VT(0);
    q.end = q.valid ? (a.causal ? r + 1 : a.T) : invalid_row_end(a, r);
  }
  return q;
}

// The logit of key j for row q: -inf past the row's end, q.k with the
// additive mask otherwise.
__device__ __forceinline__ float masked_logit(const AttnArgs& a, float dot,
                                              const QueryRow& q, int j,
                                              float key_valid) {
  if (j >= q.end) return -INFINITY;
  const bool allowed = q.valid && key_valid != 0.f && (!a.causal || j <= q.r);
  return allowed ? dot : dot + NEG;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// CTA (query tile blockIdx.x of QW slabs, head blockIdx.y, batch row
// blockIdx.z). Warp w takes slab w % QW and, of each staged key tile, the
// AK / KW keys of key group w / QW. Lane (g, t) holds rows g and g + 8 of
// its slab: their S = q.k^T fragments, an online softmax on them (max and
// denominator per row, reduced over the lane quad), and the output
// fragments of P.V, dims 2t, 2t + 1 of each 8-wide block. q.k sums its
// head width and each tile's P.V its keys on the tensor cores; the tiles'
// P.V are added in f32. The KW partial softmaxes of a slab are merged
// through shared memory at the end.
template <int QW, typename VT>
__global__ void __launch_bounds__(AT) mha_attention_kernel(AttnArgs a) {
  constexpr int KW = AW / QW;    // key groups a slab
  constexpr int KT = AK / KW;    // keys of a staged tile a warp takes
  constexpr int NBK = KT / 8;    // their n-blocks of S (k-steps of P.V)
  extern __shared__ float4 attn_smem4[];
  float* ks = reinterpret_cast<float*>(attn_smem4);  // [2][AK][LDK]
  float* vs = ks + 2 * AK * LDK;                     // [2][AK][LDK]
  float* kval = vs + 2 * AK * LDK;                   // [2][AK]
  __shared__ int cta_end;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp % QW, kg = warp / QW;
  const int h = blockIdx.y;
  const size_t base = (size_t)blockIdx.z * a.T;
  const int r0 = (blockIdx.x * QW + slab) * SLAB;
  const QueryRow rows[2] = {query_row<VT>(a, base, r0 + g),
                            query_row<VT>(a, base, r0 + g + 8)};

  // q fragments, split once; zeros past T and past DK
  FragA qa[KSTEPS];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    float e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + g + 8 * (u & 1), d = 8 * s + t + 4 * (u >> 1);
      e[u] = r < a.T && d < DK ? __ldg(a.q + ((base + r) * NH + h) * DK + d) : 0.f;
    }
    set_a(qa[s], e[0], e[1], e[2], e[3]);
  }

  // the padding columns DK..DKP stay zero; cp.async writes only DK
  if (DK != DKP)
    for (int i = threadIdx.x; i < 2 * AK; i += AT)
      for (int d = DK; d < DKP; ++d) ks[i * LDK + d] = vs[i * LDK + d] = 0.f;
  if (threadIdx.x == 0) cta_end = 0;
  __syncthreads();
  atomicMax(&cta_end, max(rows[0].end, rows[1].end));
  const int warp_end = __reduce_max_sync(0xffffffffu, max(rows[0].end, rows[1].end));
  __syncthreads();
  const int n_tiles = (cta_end + AK - 1) / AK;

  auto stage = [&](int tile, int buf) {
    const int j0 = tile * AK;
    for (int idx = threadIdx.x; idx < AK * (DK / 4); idx += AT) {
      const int jj = idx / (DK / 4), e = 4 * (idx % (DK / 4)), j = j0 + jj;
      const bool in = j < a.T;
      const size_t off = ((base + (in ? j : 0)) * NH + h) * DK + e;
      const int so = (buf * AK + jj) * LDK + e;
      cp_async16(ks + so, a.k + off, !in);
      cp_async16(vs + so, a.v + off, !in);
    }
    cp_async_commit();
    for (int jj = threadIdx.x; jj < AK; jj += AT) {
      const int j = j0 + jj;
      kval[buf * AK + jj] =
          j < a.T && static_cast<const VT*>(a.valid)[base + j] != VT(0) ? 1.f : 0.f;
    }
  };

  float acc[KSTEPS][4];
#pragma unroll
  for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) stage(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int k0 = it * AK + kg * KT;  // this warp's first key of the tile
    if (k0 < warp_end) {
      const float* kb = ks + (buf * AK + kg * KT) * LDK;
      const float* vb = vs + (buf * AK + kg * KT) * LDK;
      const float* kv = kval + buf * AK + kg * KT;
      // S for the tile's NBK key blocks (those past the warp's end are
      // computed too, on whatever the buffer holds, and masked to -inf),
      // summed over the head width on the tensor cores: at most 8 k-steps
      float s[NBK][4];
      zero(s);
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        FragB b[NBK];
#pragma unroll
        for (int nb = 0; nb < NBK; ++nb) {
          const float* kr = kb + (8 * nb + g) * LDK + 8 * st + t;
          set_b(b[nb], kr[0], kr[4]);
        }
        mma_tf32x3(s, qa[st], b);
      }
      // mask, then the online softmax of rows g (c0, c1) and g + 8 (c2, c3)
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jj = 8 * nb + 2 * t + (c & 1);
          s[nb][c] = masked_logit(a, s[nb][c], rows[c >> 1], k0 + jj, kv[jj]);
          mt[c >> 1] = fmaxf(mt[c >> 1], s[nb][c]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mt[i]));
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      // P.V of the tile summed on the tensor cores, then into acc in f32
      float pv[KSTEPS][4];
      zero(pv);
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[nb][c] = expf(s[nb][c] - m[c >> 1]);
          l[c >> 1] += s[nb][c];
        }
        if (k0 + 8 * nb < warp_end) {
          FragA p;
          c_as_a(p, s[nb]);
          const float* vr = vb + (8 * nb + 2 * t) * LDK + g;
          FragB b[KSTEPS];
#pragma unroll
          for (int n = 0; n < KSTEPS; ++n) set_b(b[n], vr[8 * n], vr[LDK + 8 * n]);
          mma_tf32x3(pv, p, b);
        }
      }
#pragma unroll
      for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = acc[n][c] * alpha[c >> 1] + pv[n][c];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);

  if (KW > 1) {
    // partials of key groups 1.. through the (now idle) key buffers:
    // [QW][KW][SLAB][DKP + 2] floats, m and l after the DKP values
    constexpr int LDM = DKP + 2;
    float* part = ks;
    if (kg > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* pr = part + ((slab * KW + kg) * SLAB + g + 8 * i) * LDM;
#pragma unroll
        for (int n = 0; n < KSTEPS; ++n) {
          pr[8 * n + 2 * t] = acc[n][2 * i];
          pr[8 * n + 2 * t + 1] = acc[n][2 * i + 1];
        }
        if (t == 0) {
          pr[DKP] = m[i];
          pr[DKP + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mm = m[i];
      for (int q = 1; q < KW; ++q)
        mm = fmaxf(mm, part[((slab * KW + q) * SLAB + g + 8 * i) * LDM + DKP]);
      const float own = expf(m[i] - mm);
      l[i] *= own;
#pragma unroll
      for (int n = 0; n < KSTEPS; ++n) {
        acc[n][2 * i] *= own;
        acc[n][2 * i + 1] *= own;
      }
      for (int q = 1; q < KW; ++q) {
        const float* pr = part + ((slab * KW + q) * SLAB + g + 8 * i) * LDM;
        const float f = expf(pr[DKP] - mm);
        l[i] += pr[DKP + 1] * f;
#pragma unroll
        for (int n = 0; n < KSTEPS; ++n) {
          acc[n][2 * i] += pr[8 * n + 2 * t] * f;
          acc[n][2 * i + 1] += pr[8 * n + 2 * t + 1] * f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= a.T) continue;
    const float inv = 1.f / l[i];
    float* op = a.out + ((base + r) * NH + h) * DK;
#pragma unroll
    for (int n = 0; n < KSTEPS; ++n)
      if (8 * n + 2 * t < DK)
        *reinterpret_cast<float2*>(op + 8 * n + 2 * t) =
            make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// The card's SM count (0 when it cannot be read), read once a process.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

template <int QW, typename VT>
cudaError_t launch_attention_qw(const AttnArgs& a, int B, cudaStream_t stream) {
  static bool ready = false;  // the shared-memory opt-in, once a process
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_attention_kernel<QW, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ATTN_SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const dim3 grid((a.T + QW * SLAB - 1) / (QW * SLAB), NH, B);
  mha_attention_kernel<QW, VT><<<grid, AT, ATTN_SMEM, stream>>>(a);
  return cudaGetLastError();
}

// One launch over B batch rows; valid holds VT (uint8 for a bool tensor, or
// float). The slabs a CTA holds: 4 (a 64-row query tile, each key tile
// staged once for 64 rows) while that gives eight CTAs an SM, else 2, else 1
// with the keys split 4 ways: the kernel is bound by latency, and more
// resident warps beat staging each key tile for more rows (B=1: 128 CTAs
// at T=250 rather than 32, 1,128 at T=2250 rather than 288).
template <typename VT>
cudaError_t launch_attention(const AttnArgs& a, int B, cudaStream_t stream) {
  if (B < 1 || a.T < 1 || a.n_keys < a.T || B > 65535 ||
      (a.skip_bq > 0 && (a.skip_bk < 1 || a.n_keys % a.skip_bk != 0)))
    return cudaErrorInvalidValue;
  const int n_sm = sm_count();
  if (n_sm == 0) return cudaErrorUnknown;
  const long rows_ctas = (long)NH * B;
  auto ctas = [&](int qw) { return (a.T + qw * SLAB - 1) / (qw * SLAB) * rows_ctas; };
  if (ctas(4) >= 8L * n_sm) return launch_attention_qw<4, VT>(a, B, stream);
  if (ctas(2) >= 8L * n_sm) return launch_attention_qw<2, VT>(a, B, stream);
  return launch_attention_qw<1, VT>(a, B, stream);
}

}  // namespace
