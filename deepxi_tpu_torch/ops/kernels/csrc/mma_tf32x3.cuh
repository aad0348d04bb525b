// f32-accurate matrix products on Hopper's tensor cores (sm_90a), and the
// cp.async staging the kernels that use them share (mha_common.cuh's
// attention, tcn_common.cuh's window product).
//
// A warp-level mma.sync.aligned.m16n8k8 TF32 product keeps 10 mantissa bits
// of each operand (unit round-off 4.9e-4), which through 5 to 40 LayerNorm'd
// blocks lands near the 1e-4-of-scale gate the kernels are held to. So each
// f32 operand x is split into hi + lo, and a product takes
//   a.b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi
// summed in f32 (the small terms first); a_lo b_lo, below f32's round-off,
// is left out. hi = tf32(x), rounded to nearest, ties away, as cvt.rna,
// and lo = tf32(x - hi): four integer instructions and a subtraction
// (`split_tf32`). That is three TF32 products for one f32 product:
// 495 / 3 = 165 TFLOP/s of dense f32-accurate work on an H100 SXM, against
// 67 TFLOP/s of f32 FMA outside the tensor cores.
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k by n):     b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C, D (16 x 8):         c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// A sum over k may take its k in any order, so long as A's columns and B's
// rows agree: a C fragment of scores becomes the A fragment of the next
// product with no shuffle by reading column t as key 2t and column t + 4 as
// key 2t + 1 (`c_as_a`), and B's rows as the same keys.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x rounded to TF32 (the low 13 mantissa bits zero), as f32 bits: round to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds a finite x, in
// two integer instructions, which issue at a higher rate than a cvt.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (x's bits below both), as the header comment says.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

struct FragA {  // a 16 x 8 A operand, split
  uint32_t hi[4], lo[4];
};
struct FragB {  // an 8 x 8 B operand, split
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void set_a(FragA& f, float a0, float a1, float a2,
                                      float a3) {
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void set_b(FragB& f, float b0, float b1) {
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
}

// A C fragment (c0..c3 of one 16 x 8 block) as the A operand of a k-step of
// 8 whose column t is C's column 2t and column t + 4 is C's 2t + 1.
__device__ __forceinline__ void c_as_a(FragA& f, const float (&c)[4]) {
  set_a(f, c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// p[n] += a.b[n] to f32 accuracy for N n-blocks, on the tensor cores: the
// three TF32 products, small terms first, each pass over all N n-blocks so
// that N independent products are in flight.
//
// The tensor cores' f32 accumulation does not round to nearest, so a long
// sum is not left to them: callers sum a few k-steps here into a fresh
// fragment and add that to their running sum in f32 (`add_to`). Carried
// through the tensor cores over all 32 k-steps of W1, the TCN forward
// drifted from float64 several times as far as plain f32 does, and the
// training gradients failed their 2e-4 gate on ReLU ties; summed this way
// it stays at plain f32's distance (chip_smoke.py phase 2; PERF.md, PR 7).
template <int N>
__device__ __forceinline__ void mma_tf32x3(float (&p)[N][4], const FragA& a,
                                           const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(p[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(p[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(p[n], a.hi, b[n].hi);
}

template <int N>
__device__ __forceinline__ void zero(float (&p)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
}

template <int N>
__device__ __forceinline__ void add_to(float (&d)[N][4], const float (&p)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[n][c] += p[n][c];
}

// 16 bytes global -> shared without passing through registers; with
// `fill_zero` no byte is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill_zero = false) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = fill_zero ? 0 : 16;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace
