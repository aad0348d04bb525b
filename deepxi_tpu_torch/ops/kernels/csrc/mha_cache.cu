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
// valid_j = (j <= t) for the stream's clock t, shared by every batch row.
// The kernel reads t from device memory (a 0-d int32 tensor), so a CUDA
// graph that captured one call computes the step at whatever clock the
// stream holds when it is replayed. Row 0 is always written, so each masked
// logit is at least 1e10 below the maximum and exp() of it is exactly 0 in
// f32: the kernel visits only the n_valid = min(t + 1, L) written rows and
// adds those exact zeros by leaving the rows out.
//
// What bounds it on this card (mhanet-1.1c's 8 heads of 32): bytes. Each
// written row of K and V is read once (512 values a row, f32 or bf16) for
// 4 * 256 FLOP: 0.5 (f32) or 1 (bf16) FLOP a byte, far below the card's
// 20 FLOP/byte balance of f32 CUDA cores to HBM, so no tensor cores. The
// design keeps bytes in flight while the warps compute:
//   * A CTA holds all NH heads of one batch row, so a tile of TK keys is one
//     contiguous block of TK * NH * DK elements of each cache. One producer
//     warp fills a ring of NSTAGE stages (K tile, V tile) in shared memory
//     with 1-D bulk copies (cp.async.bulk, the TMA without a tensor map),
//     each completing on the stage's `full` mbarrier; the consumer warps
//     release a stage on its `empty` mbarrier. Where a row of one cache is
//     not a multiple of 16 bytes (bf16 with NH * DK % 8 != 0) the producer
//     warp's lanes copy the block with 8-byte cp.async instead, tracked by
//     the same mbarrier (cp.async.mbarrier.arrive.noinc).
//   * Score layout: lane = head dimension. The tile sits in shared memory
//     unpadded, so lane j reading key j's row of head h would stride by
//     NH * DK floats (a 32-way bank conflict at the flagship widths).
//     Instead each lane forms q[d] k[j, d] for every key j of the tile
//     (consecutive lanes, consecutive words), and a halving butterfly
//     (TK - 1 shuffles for TK keys, then 5 - log2 TK plain steps) leaves
//     key j's dot product in lane j * 32 / TK. Values are read with lane =
//     head dimension as well, each key's probability broadcast by shuffle.
//   * The grid depends only on (B, L): S key splits a batch row (enough
//     CTAs for two on each SM; S = 1 once B fills that), each CTA taking
//     whole 32-key chunks of [0, n_valid) by the balanced split
//     [s * nc / S, (s + 1) * nc / S) of the nc chunks, computed on the card.
//     A CTA whose range is empty only takes part in the merge. With S > 1
//     each CTA writes its running max, sum and unnormalised accumulator to
//     scratch, and the last CTA of the batch row to finish (a counter a row,
//     which it resets to zero) merges them in split order 0, 1, .., with
//     32 splits' loads in flight at a time: one launch, bitwise repeatable,
//     and the counters are as they were found, so graph replays need no
//     reset.
// The tile length TK comes from the widths: 16 keys, fewer where a stage
// (K and V) would pass 32 KB. At the flagship widths three stages take 48 KB
// (bf16) or 96 KB (f32), and 16-key bf16 tiles ran faster at B=256 than
// 32-key ones; at 1024 columns TK is 4 (f32) or 8 (bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "deepxi_error.cuh"

namespace {

#if !defined(MHA_NH) || !defined(MHA_DK)
#error "build with -DMHA_NH=<heads> -DMHA_DK=<head width>"
#endif

constexpr int NH = MHA_NH;  // heads
constexpr int DK = MHA_DK;  // head width
constexpr int C = NH * DK;  // values in a cache row
constexpr int DL = (DK + 31) / 32;             // head dimensions a lane holds: lane + 32 e
constexpr int NW = NH < 8 ? NH : 8;            // consumer warps
constexpr int HPW = (NH + NW - 1) / NW;        // heads a consumer warp takes: w, w + NW, ..
constexpr int THREADS = (NW + 1) * 32;         // and one producer warp
constexpr int CHUNK = 32;                      // keys: the unit of the split
constexpr int NSTAGE = 3;
constexpr int STAGE_BYTES = 32 * 1024;         // K and V tiles of a stage, at most
constexpr unsigned FULL = 0xffffffffu;
static_assert(NH >= 1 && NH <= 32 && DK % 4 == 0 && DK >= 4 && DK <= 64 && C <= 1024,
              "at most 32 heads and 1024 columns, head widths a multiple of 4 up to 64");

template <typename T>
struct Tile {
  static constexpr int ROW = C * (int)sizeof(T);  // bytes of a cache row
  // keys a stage holds: the largest power of two <= 16 whose K and V fit
  static constexpr int LOG_TK = 2 * 16 * ROW <= STAGE_BYTES  ? 4
                                : 2 * 8 * ROW <= STAGE_BYTES ? 3
                                                             : 2;
  static constexpr int TK = 1 << LOG_TK;
  static constexpr bool BULK = ROW % 16 == 0;  // else 8-byte cp.async
  static constexpr int ELEMS = TK * C;         // elements of one cache's tile
  static constexpr size_t SMEM = (size_t)NSTAGE * 2 * ELEMS * sizeof(T)
                                 + 2 * NSTAGE * sizeof(uint64_t);
  static_assert(CHUNK % TK == 0 && 2 * TK * ROW <= STAGE_BYTES, "a stage fits");
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global src to shared dst, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void copy8_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The barrier's pending count drops by one when this thread's cp.asyncs land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The halving butterfly over a warp: p[j] holds this lane's part of key
// j's dot product (CNT keys left); at offset O a lane keeps the half of the
// keys whose index bit matches its lane bit and adds its partner's part of
// them. Returns the whole dot product of key lane >> (5 - log2 CNT).
template <int CNT, int O = 16>
__device__ __forceinline__ float reduce_keys(float* p, int lane) {
  if constexpr (O == 0) {
    return p[0];
  } else if constexpr (CNT > 1) {
    constexpr int H = CNT / 2;
    const bool upper = lane & O;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float give = upper ? p[j] : p[j + H];
      const float keep = upper ? p[j + H] : p[j];
      p[j] = keep + __shfl_xor_sync(FULL, give, O);
    }
    return reduce_keys<H, O / 2>(p, lane);
  } else {
    p[0] += __shfl_xor_sync(FULL, p[0], O);
    return reduce_keys<1, O / 2>(p, lane);
  }
}

// The clock's written rows: min(t + 1, L), and at least row 0.
__device__ __forceinline__ int written_rows(const int* clock, int L) {
  const int t = max(__ldg(clock), 0);
  return t >= L ? L : t + 1;
}

// CTA (split s = blockIdx.x of S = gridDim.x, batch row b = blockIdx.y);
// warps 0 .. NW-1 consume, warp NW produces. With S == 1 the CTA writes
// out[b]; otherwise part [B, S, NH, DK + 2] (the accumulator, then the max
// and the sum) and the last CTA of row b merges (counters [B], zero).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    mha_cache_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ clock,
                     float* __restrict__ out, float* __restrict__ part,
                     int* __restrict__ counters, int L) {
  using Tl = Tile<T>;
  constexpr int TK = Tl::TK;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // stage st: K at 2 st, V at 2 st + 1 (ELEMS each)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)NSTAGE * 2 * Tl::ELEMS * sizeof(T));
  uint64_t* empty = full + NSTAGE;
  __shared__ int last;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x, S = gridDim.x, b = blockIdx.y;
  const int n_valid = written_rows(clock, L);
  const int nc = (n_valid + CHUNK - 1) / CHUNK;
  const int k0 = (int)((long long)s * nc / S) * CHUNK;
  const int k1 = min((int)((long long)(s + 1) * nc / S) * CHUNK, n_valid);
  const int n_tiles = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NSTAGE; ++i) {
      mbar_init(full + i, Tl::BULK ? 1 : 32);
      mbar_init(empty + i, NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW) {
    // producer: tile i into stage i % NSTAGE once its consumers released it
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % NSTAGE;
      mbar_wait(empty + st, ((i / NSTAGE) & 1) ^ 1);
      const int j0 = k0 + i * TK, n = min(TK, k1 - j0);
      const size_t off = ((size_t)b * L + j0) * C;
      T* kd = ring + (size_t)(2 * st) * Tl::ELEMS;
      T* vd = kd + Tl::ELEMS;
      const uint32_t bytes = (uint32_t)(n * Tl::ROW);
      if constexpr (Tl::BULK) {
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * bytes);
          bulk_copy(kd, k + off, bytes, full + st);
          bulk_copy(vd, v + off, bytes, full + st);
        }
      } else {
        const char* ks = reinterpret_cast<const char*>(k + off);
        const char* vs = reinterpret_cast<const char*>(v + off);
        for (uint32_t c = 8 * lane; c < bytes; c += 8 * 32) {
          copy8_async(reinterpret_cast<char*>(kd) + c, ks + c);
          copy8_async(reinterpret_cast<char*>(vd) + c, vs + c);
        }
        cp_async_arrive(full + st);
      }
    }
  } else {
    // consumers: warp w takes heads w, w + NW, ..; lane = head dimension
    float qv[HPW][DL], acc[HPW][DL], m[HPW], l[HPW];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int h = warp + NW * hh;
      m[hh] = -INFINITY;
      l[hh] = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        acc[hh][e] = 0.f;
        qv[hh][e] = h < NH && in_head(lane, e) ? q[((size_t)b * NH + h) * DK + lane + 32 * e]
                                               : 0.f;
      }
    }
    // the key whose dot product this lane ends with, and whether it counts
    // that key in the sum (32 / TK lanes end with each key)
    const int jl = lane >> (5 - Tl::LOG_TK);
    const bool owner = (lane & ((32 >> Tl::LOG_TK) - 1)) == 0;

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % NSTAGE;
      mbar_wait(full + st, (i / NSTAGE) & 1);
      const int n = min(TK, k1 - (k0 + i * TK));
      const T* ks = ring + (size_t)(2 * st) * Tl::ELEMS;
      const T* vs = ks + Tl::ELEMS;
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const int h = warp + NW * hh;
        if (HPW > 1 && h >= NH) break;  // uniform across the warp
        const int col = h * DK + lane;
        float p[TK];
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          float d = 0.f;
          if (j < n) {
#pragma unroll
            for (int e = 0; e < DL; ++e)
              if (in_head(lane, e)) d = fmaf(qv[hh][e], to_f32(ks[j * C + col + 32 * e]), d);
          }
          p[j] = d;
        }
        const float dot = reduce_keys<TK>(p, lane);
        const float sc = jl < n ? dot : -INFINITY;
        const float m_new = fmaxf(m[hh], warp_max(sc));
        const float alpha = expf(m[hh] - m_new);  // 0 on the first tile (m = -inf)
        const float pe = jl < n ? expf(sc - m_new) : 0.f;
        l[hh] = l[hh] * alpha + (owner ? pe : 0.f);
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[hh][e] *= alpha;
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          if (j < n) {
            const float pj = __shfl_sync(FULL, pe, j << (5 - Tl::LOG_TK));
#pragma unroll
            for (int e = 0; e < DL; ++e)
              if (in_head(lane, e))
                acc[hh][e] = fmaf(pj, to_f32(vs[j * C + col + 32 * e]), acc[hh][e]);
          }
        }
        m[hh] = m_new;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }

#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int h = warp + NW * hh;
      if (HPW > 1 && h >= NH) break;
      const float lt = warp_sum(l[hh]);
      if (S == 1) {
#pragma unroll
        for (int e = 0; e < DL; ++e)
          if (in_head(lane, e)) out[((size_t)b * NH + h) * DK + lane + 32 * e] = acc[hh][e] / lt;
      } else {
        float* pp = part + (((size_t)b * S + s) * NH + h) * (DK + 2);
#pragma unroll
        for (int e = 0; e < DL; ++e)
          if (in_head(lane, e)) pp[lane + 32 * e] = acc[hh][e];
        if (lane == 0) {
          pp[DK] = m[hh];
          pp[DK + 1] = lt;
        }
      }
    }
  }
  if (S == 1) return;

  // the last CTA of batch row b to finish merges the S partials in split
  // order, 32 splits at a time: lane r takes split r's max and sum, and
  // each lane loads its head dimensions of the 32 accumulators at once and
  // sums them in order 0, 1, .. (a split without keys adds exact zeros)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + b, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (warp < NW) {
    const size_t step = (size_t)NH * (DK + 2);
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int h = warp + NW * hh;
      if (HPW > 1 && h >= NH) break;
      const float* pb = part + ((size_t)b * S * NH + h) * (DK + 2);
      float mx = -INFINITY;
      for (int r = lane; r < S; r += 32) mx = fmaxf(mx, __ldcg(pb + r * step + DK));
      mx = warp_max(mx);
      float lt = 0.f, a[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) a[e] = 0.f;
      for (int g = 0; g < S; g += 32) {
        const float* pl = pb + (g + lane) * step;
        const float w = g + lane < S ? expf(__ldcg(pl + DK) - mx) : 0.f;
        if (g + lane < S) lt = fmaf(__ldcg(pl + DK + 1), w, lt);
        float acc_r[32][DL];
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < DL; ++e)
            acc_r[j][e] = g + j < S && in_head(lane, e)
                              ? __ldcg(pb + (g + j) * step + lane + 32 * e)
                              : 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float wj = __shfl_sync(FULL, w, j);
#pragma unroll
          for (int e = 0; e < DL; ++e) a[e] = fmaf(acc_r[j][e], wj, a[e]);
        }
      }
      lt = warp_sum(lt);
#pragma unroll
      for (int e = 0; e < DL; ++e)
        if (in_head(lane, e)) out[((size_t)b * NH + h) * DK + lane + 32 * e] = a[e] / lt;
    }
  }
  if (threadIdx.x == 0) counters[b] = 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* clock, void* out,
           void* part, void* counters, int B, int L, int S, cudaStream_t st) {
  static bool attr_set[64] = {};  // once a dtype and device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (Tile<T>::SMEM > 48 * 1024 && (dev >= 64 || !attr_set[dev])) {
    e = cudaFuncSetAttribute(mha_cache_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile<T>::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[dev] = true;
  }
  mha_cache_kernel<T><<<dim3(S, B), THREADS, Tile<T>::SMEM, st>>>(
      (const float*)q, (const T*)k, (const T*)v, (const int*)clock, (float*)out,
      (float*)part, (int*)counters, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B, NH, DK] f32 for q [B, NH, DK] f32, caches k, v [B, L, NH, DK]
// (bf16 != 0: bfloat16, else float32) and the clock, a device int32. S key
// splits a batch row (1 <= S <= ceil(L / 32)); with S > 1, part [B, S, NH,
// DK + 2] floats of scratch and counters [B] int32, zero (left zero). One
// launch; returns 0 or its CUDA error.
int mha_cache_forward(const void* q, const void* k, const void* v, const void* clock,
                      void* out, void* part, void* counters, int B, int L, int S, int bf16,
                      void* stream) {
  if (B < 1 || B > 65535 || L < 1 || S < 1 || S > (L + CHUNK - 1) / CHUNK || !clock ||
      (S > 1 && (!part || !counters)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(q, k, v, clock, out, part, counters, B, L, S, st)
              : launch<float>(q, k, v, clock, out, part, counters, B, L, S, st);
}

}  // extern "C"
