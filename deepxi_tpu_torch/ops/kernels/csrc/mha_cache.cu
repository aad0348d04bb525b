// KV-cache attention step of streaming MHANet for Hopper (sm_90a).
//
// Replaces deepxi_tpu/ops/kernels/mha_cache.py::mha_cache_step (Pallas): per
// (batch row b, head h) one pre-scaled f32 query row q[b, h] against the
// [B, L, NH, DK] key and value caches (f32, or bf16 upcast to f32 exactly
// as `.astype(jnp.float32)` does), logits q.k + (-1e10)(1 - valid_j), a
// softmax over the L rows, the weighted values summed in f32: out[b, h]
// [B, NH, DK]. The widths are build defines (MHA_NH, MHA_DK), one library
// per set of widths (_build.py).
//
// valid_j = (j <= t) for the stream's clock t, shared by every batch row. Row
// 0 is always written, so each masked logit is at least 1e10 below the
// maximum and exp() of it is exactly 0 in f32: the kernel visits only the
// n_valid = min(t + 1, L) written rows (a launch argument) and adds those
// exact zeros by leaving the rows out.
//
// What bounds it on this card (mhanet-1.1c's 8 heads of 32): bytes. Each
// written row is read once, K and V
// (512 values a row, f32 or bf16), for 4 * 256 FLOP a row: 0.5 (f32) or 1
// (bf16) FLOP a byte, far below the card's 20 FLOP/byte balance of f32 CUDA
// cores to HBM. The TPU kernel holds a whole [L, H*d] panel in VMEM per batch
// row; here one warp takes one head and walks its keys 32 at a time: it
// stages the 32 key rows through shared memory with 16-byte coalesced loads
// (each lane then scores one key against q in registers), folds the tile
// into a running max and sum, and weights the values with lane = head
// dimension (lane + 32 e past 32), so each key's value row is one coalesced
// read. A CTA holds the NH heads of one batch row, so a row of the cache
// (all heads) is read by one CTA. At small B the keys are split across CTAs (grid x) and a second
// launch merges the partial softmaxes, so B = 1 still spreads over the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

#if !defined(MHA_NH) || !defined(MHA_DK)
#error "build with -DMHA_NH=<heads> -DMHA_DK=<head width>"
#endif

constexpr int NH = MHA_NH;  // heads, a warp each
constexpr int DK = MHA_DK;  // head width
constexpr int TK = 32;      // keys a warp scores at a time, one per lane
constexpr int LDK = DK + 1; // padded row of a staged key tile
constexpr int DL = (DK + 31) / 32;  // head dimensions a lane holds: lane + 32 e
constexpr unsigned FULL = 0xffffffffu;
static_assert(NH >= 1 && NH <= 32 && DK % 4 == 0 && DK >= 4 && DK <= 64,
              "at most 32 heads, head widths a multiple of 4 up to 64");

// Shared memory of a CTA: one staged key tile a warp.
constexpr size_t SMEM = (size_t)NH * TK * LDK * sizeof(float);

__device__ __forceinline__ bool in_head(int lane, int e) {
  return DK % 32 == 0 || lane + 32 * e < DK;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stage head h's key rows row0 .. row0 + n - 1 (row = b * L + j) into
// ks[TK][LDK] as f32; the padding keeps both the stores and each lane's
// reads of its own row free of bank conflicts.
__device__ __forceinline__ void stage_keys(const float* k, size_t row0, int h,
                                           int n, float* ks, int lane) {
  // a row of one head is DK / 4 float4
  constexpr int V = DK / 4;
#pragma unroll
  for (int it = 0; it < (TK * V + 31) / 32; ++it) {
    const int idx = it * 32 + lane, jj = idx / V, e = (idx % V) * 4;
    if (jj < n && idx < TK * V) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          k + ((row0 + jj) * NH + h) * DK + e));
      float* dst = ks + jj * LDK + e;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  }
}

__device__ __forceinline__ void stage_keys(const __nv_bfloat16* k, size_t row0,
                                           int h, int n, float* ks, int lane) {
  // a row of one head is DK / E loads of E bf16: 16 bytes, or 8 when 8 ∤ DK
  constexpr int E = DK % 8 == 0 ? 8 : 4, V = DK / E;
#pragma unroll
  for (int it = 0; it < (TK * V + 31) / 32; ++it) {
    const int idx = it * 32 + lane, jj = idx / V, e = (idx % V) * E;
    if (jj < n && idx < TK * V) {
      using Raw = std::conditional_t<E == 8, uint4, uint2>;
      const Raw raw = __ldg(reinterpret_cast<const Raw*>(
          k + ((row0 + jj) * NH + h) * DK + e));
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int c = 0; c < E; ++c) ks[jj * LDK + e + c] = __bfloat162float(b[c]);
    }
  }
}

// CTA (key split blockIdx.x, batch row blockIdx.y); warp h = head h. Each
// warp walks keys [s * keys_per_split, min(.. + keys_per_split, n_valid)).
// With n_split == 1 it writes out[b, h] directly; otherwise its running max,
// sum and unnormalised accumulator go to part_* for mha_cache_merge.
template <typename T>
__global__ void __launch_bounds__(NH * 32)
    mha_cache_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     float* __restrict__ part_acc, int L, int n_valid,
                     int keys_per_split, int n_split) {
  extern __shared__ float smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ks = smem + h * TK * LDK;
  const int s = blockIdx.x, b = blockIdx.y;
  const int k0 = s * keys_per_split;
  const int k1 = min(k0 + keys_per_split, n_valid);

  float qr[DK];
  const float4* qp = reinterpret_cast<const float4*>(q + ((size_t)b * NH + h) * DK);
#pragma unroll
  for (int e = 0; e < DK / 4; ++e) {
    const float4 t = __ldg(qp + e);
    qr[4 * e] = t.x;
    qr[4 * e + 1] = t.y;
    qr[4 * e + 2] = t.z;
    qr[4 * e + 3] = t.w;
  }

  float m = -INFINITY, l = 0.f, acc[DL];
#pragma unroll
  for (int e = 0; e < DL; ++e) acc[e] = 0.f;
  for (int j0 = k0; j0 < k1; j0 += TK) {
    const int n = min(TK, k1 - j0);
    const size_t row0 = (size_t)b * L + j0;
    // this lane's value columns of the tile's rows, loaded ahead of use
    const T* vcol = v + (row0 * NH + h) * DK + lane;
    float vv[TK][DL];
#pragma unroll
    for (int jj = 0; jj < TK; ++jj)
#pragma unroll
      for (int e = 0; e < DL; ++e)
        vv[jj][e] = jj < n && in_head(lane, e)
                        ? to_f32(vcol[(size_t)jj * NH * DK + 32 * e])
                        : 0.f;

    stage_keys(k, row0, h, n, ks, lane);
    __syncwarp();
    float sc = -INFINITY;
    if (lane < n) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < DK; ++e) dot = fmaf(qr[e], ks[lane * LDK + e], dot);
      sc = dot;
    }
    const float m_new = fmaxf(m, warp_max(sc));
    const float alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)
    const float p = lane < n ? expf(sc - m_new) : 0.f;
    l = l * alpha + p;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int jj = 0; jj < TK; ++jj) {
      const float pj = __shfl_sync(FULL, p, jj);
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[e] = fmaf(pj, vv[jj][e], acc[e]);
    }
    m = m_new;
    __syncwarp();  // the next tile overwrites ks
  }

  l = warp_sum(l);
  if (n_split == 1) {
#pragma unroll
    for (int e = 0; e < DL; ++e)
      if (in_head(lane, e)) out[((size_t)b * NH + h) * DK + lane + 32 * e] = acc[e] / l;
  } else {
    const size_t idx = ((size_t)b * n_split + s) * NH + h;
#pragma unroll
    for (int e = 0; e < DL; ++e)
      if (in_head(lane, e)) part_acc[idx * DK + lane + 32 * e] = acc[e];
    if (lane == 0) {
      part_m[idx] = m;
      part_l[idx] = l;
    }
  }
}

// One CTA per batch row, warp h = head h, lane = head dimension(s): the
// softmax of the whole row from the splits' partial maxima, sums and
// accumulators.
__global__ void __launch_bounds__(NH * 32)
    mha_cache_merge(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, float* __restrict__ out,
                    int n_split) {
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31, b = blockIdx.x;
  const size_t base = (size_t)b * n_split * NH + h;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[base + (size_t)s * NH]);
  float l = 0.f, acc[DL];
#pragma unroll
  for (int e = 0; e < DL; ++e) acc[e] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t idx = base + (size_t)s * NH;
    const float w = expf(part_m[idx] - mx);
    l = fmaf(part_l[idx], w, l);
#pragma unroll
    for (int e = 0; e < DL; ++e)
      if (in_head(lane, e)) acc[e] = fmaf(part_acc[idx * DK + lane + 32 * e], w, acc[e]);
  }
#pragma unroll
  for (int e = 0; e < DL; ++e)
    if (in_head(lane, e)) out[((size_t)b * NH + h) * DK + lane + 32 * e] = acc[e] / l;
}

}  // namespace

extern "C" {

const char* mha_cache_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out [B, NH, DK] f32 for q [B, NH, DK] f32 and caches k, v [B, L, NH, DK]
// (bf16 != 0: bfloat16, else float32). The keys [0, n_valid) are split into
// n_split runs of keys_per_split (a multiple of 32; every run non-empty);
// with n_split > 1, part_m and part_l [B, n_split, NH] and part_acc
// [B, n_split, NH, DK] hold the partial softmaxes and a second launch merges
// them. Returns 0 or the CUDA error of the launch.
int mha_cache_forward(const void* q, const void* k, const void* v, void* out,
                      void* part_m, void* part_l, void* part_acc, int B, int L,
                      int n_valid, int keys_per_split, int n_split, int bf16,
                      void* stream) {
  if (B < 1 || B > 65535 || L < 1 || n_valid < 1 || n_valid > L ||
      keys_per_split < TK || keys_per_split % TK != 0 || n_split < 1 ||
      (long long)(n_split - 1) * keys_per_split >= n_valid ||
      (long long)n_split * keys_per_split < n_valid ||
      (n_split > 1 && (!part_m || !part_l || !part_acc)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bf16 ? (const void*)mha_cache_kernel<__nv_bfloat16>
             : (const void*)mha_cache_kernel<float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_split, B);
  if (bf16)
    mha_cache_kernel<__nv_bfloat16><<<grid, NH * 32, SMEM, st>>>(
        (const float*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (float*)out, (float*)part_m, (float*)part_l, (float*)part_acc, L,
        n_valid, keys_per_split, n_split);
  else
    mha_cache_kernel<float><<<grid, NH * 32, SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out,
        (float*)part_m, (float*)part_l, (float*)part_acc, L, n_valid,
        keys_per_split, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  mha_cache_merge<<<B, NH * 32, 0, st>>>((const float*)part_m, (const float*)part_l,
                                         (const float*)part_acc, (float*)out, n_split);
  return (int)cudaGetLastError();
}

}  // extern "C"
