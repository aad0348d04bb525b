// Masked multi-head attention for Hopper (sm_90a), float32 values.
//
// Replaces two Pallas kernels with one CUDA kernel (mha_common.cuh):
//   * deepxi_tpu/ops/kernels/mha_fused.py::flash_attention (whole K/V panels
//     in VMEM, a full-row softmax over T rounded up to 128 keys);
//   * deepxi_tpu/ops/kernels/mha_flash_stream.py::flash_attention_streaming
//     (online softmax over key tiles; causal runs skip the tiles above each
//     query tile's diagonal).
// The two differ only in the keys a fully masked (padded) query row visits,
// which the launch states as n_keys and the skip tile sizes.
//
// What bounds it on this card (mhanet-1.1c's 8 heads of 32): 4 * 32 FLOP
// per (query row, head, key), with q, k, v read and the output written
// once, so operations at any length past a few hundred frames: B=1, T=2250
// causal is 2.6 GFLOP, 39 us at the 67 TFLOP/s f32 CUDA-core peak and 16 us
// at the 165 TFLOP/s of f32-accurate (3xTF32) tensor-core products, against
// 2.8 us of HBM traffic. The TPU keeps a whole K/V panel (or a [block_q,
// block_k] score tile) in VMEM; here a warp owns 16 query rows, S = q.k^T
// and P.V run as m16n8k8 TF32 products split hi/lo to f32 accuracy
// (mma_tf32x3.cuh), the online softmax runs on the score fragments, and
// 64-key K/V tiles stream through shared memory double-buffered with
// cp.async, the next tile in flight during the current tile's products. No
// [T, T] score ever exists and the length is unbounded. Short sequences
// split each 16-row slab's keys over a CTA's 4 warps (merged in shared
// memory), so B=1, T=250 fills 128 CTAs rather than 32.
//
// valid is the caller's bool tensor, read as bytes: no conversion launch.

#include "deepxi_error.cuh"
#include "mha_common.cuh"

extern "C" {

// out[b, t, h, :] = softmax-weighted values for q, k, v [B, T, NH, DK] and
// valid [B, T] (bool, one byte each). skip_bq = 0: every invalid row visits n_keys keys
// (flash_attention); skip_bq > 0: causal key-tile skipping with tiles of
// skip_bq queries and skip_bk keys (flash_attention_streaming).
int mha_attention_forward(const void* q, const void* k, const void* v,
                          const void* valid, void* out, int B, int T,
                          int n_keys, int causal, int skip_bq, int skip_bk,
                          void* stream) {
  AttnArgs a{(const float*)q, (const float*)k, (const float*)v,
             valid, (float*)out, T, n_keys, causal, skip_bq, skip_bk};
  return launch_attention<uint8_t>(a, B, (cudaStream_t)stream);
}

}  // extern "C"
