// Spectral kernels for Hopper (sm_90a), float32 throughout: an FFT a frame,
// in shared memory.
//
// Replace the Pallas kernels of deepxi_tpu/ops/kernels/spectral.py:
//   * stft_mag_forward -> stft_mag_pallas: hop rows x2d [B, T+1, N_s]
//     (N_d = 2 N_s) to magnitudes [B, T, nb], nb = K/2 + 1. Frame t is hop
//     rows t and t+1, Hamming-windowed and zero-padded to K samples; only
//     |X| of its real DFT is written.
//   * enhance_frames_forward -> enhance_frames_pallas: the gain G [B, T, nb]
//     times the spectrum Y [B, T, 2 nb] (re, then im), the inverse real DFT
//     of length K, the first N_d samples times the COLA synthesis window:
//     frames [B, T, N_d], overlap-added by the caller. The imaginary parts of
//     the DC and Nyquist bins are ignored, as irfft (and the synthesis
//     matrix's rows sin(0), sin(pi n)) ignores them.
// The functions are those of the windowed-DFT products of the TPU kernels
// (spectral.py's plain versions keep the products as the definition).
//
// What bounds them: bytes. A frame moves 3 KB (a hop row in, a magnitude row
// out) or 5 KB (spectrum, gain and frame), and its FFT takes ~2.5 K log2 K =
// 11.5 KFLOP at K = 512, 45x less than the dense product the TPU kernels run
// on their matrix unit. So the design keeps each frame in shared memory from
// its load to its store, and reads no matrix: only the window and a table
// of the K/2 + 1 twiddles e^{-2 pi i j / K} (float64 on the host, stored f32).
//
// Design. A real frame of K samples is packed as M = K/2 complex points
// z[m] = x[2m] + i x[2m+1] and goes through an M-point complex FFT: Stockham
// autosort passes of radix 8 (the last of radix 4 or 2 where log2 M is no
// multiple of 3; 256 = 8 * 8 * 4), each butterfly in registers, exchanges
// through two padded shared-memory buffers (complex point p lives at
// p + p/16, so the stride-R writes of the first passes spread over the
// banks). The real-FFT split step then gives X[k], k = 0 .. M, from Z[k] and
// Z[M - k]; synthesis runs the inverse pre-step, the same passes on the
// conjugate, and unpacks. A CTA takes F frames (F M <= 2048 points; the
// wrapper takes 1024 where it can and halves F until the grid fills the
// card) with F M / 8 threads, one radix-8 butterfly each a pass. stft_mag
// stages its hop rows, one contiguous run, with flat float4 loads into its
// second FFT buffer (free until the second pass) and windows and packs them
// in its first pass. enhance_frames reads Y and G once, straight from device
// memory in its pre-step (thread k reads bins k and M - k of a frame: each
// warp's reads are contiguous); staging them too would add 3 (K/2 + 1)
// floats a frame of shared memory and leave fewer CTAs an SM. Both stage
// their output rows, one contiguous run, in a free FFT buffer and store them
// as flat float4, at the run's own offset mod 4 so that the 16-byte aligned
// middle of a row that is not (257 floats) still moves as float4.

#include <cuda_runtime.h>
#include <stdint.h>

#include "deepxi_error.cuh"

namespace {

constexpr int MAX_POINTS = 2048;  // complex points (F frames x M) a CTA holds
constexpr int MAX_THREADS = MAX_POINTS / 8;

__host__ __device__ inline int pad(int p) { return p + (p >> 4); }
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
// complex points of one frame's padded buffer
__host__ __device__ inline int frame_stride(int M) { return M + (M >> 4); }

__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// e^{-2 pi i idx / K} for 0 <= idx < K from the table of idx <= M = K/2.
__device__ __forceinline__ float2 twiddle(const float2* tab, int idx, int M) {
  if (idx <= M) return tab[idx];
  const float2 w = tab[idx - M];
  return make_float2(-w.x, -w.y);
}

// In-place DFTs, natural order in and out.
__device__ __forceinline__ void dft(float2 (&v)[2]) {
  const float2 t = sub(v[0], v[1]);
  v[0] = add(v[0], v[1]);
  v[1] = t;
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = add(a0, a2), t2 = sub(a0, a2), t1 = add(a1, a3), d = sub(a1, a3);
  const float2 t3 = make_float2(d.y, -d.x);  // -i (a1 - a3)
  a0 = add(t0, t1);
  a1 = add(t2, t3);
  a2 = sub(t0, t1);
  a3 = sub(t2, t3);
}

__device__ __forceinline__ void dft(float2 (&v)[4]) { dft4(v[0], v[1], v[2], v[3]); }

// Decimation in frequency: the sums give the even outputs, the differences
// times e^{-2 pi i r / 8} the odd ones.
__device__ __forceinline__ void dft(float2 (&v)[8]) {
  const float h = 0.70710678118654752f;
  float2 a[4], b[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r] = add(v[r], v[r + 4]);
    b[r] = sub(v[r], v[r + 4]);
  }
  b[1] = make_float2((b[1].x + b[1].y) * h, (b[1].y - b[1].x) * h);
  b[2] = make_float2(b[2].y, -b[2].x);
  b[3] = make_float2((b[3].y - b[3].x) * h, -(b[3].x + b[3].y) * h);
  dft4(a[0], a[1], a[2], a[3]);
  dft4(b[0], b[1], b[2], b[3]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    v[2 * r] = a[r];
    v[2 * r + 1] = b[r];
  }
}

// Twiddles w[r] = e^{-2 pi i r idx0 / K}, r = 1 .. R-1, of a butterfly: r = 1,
// 2, 4 from the table, the others as products of two of them.
template <int R>
__device__ __forceinline__ void butterfly_twiddles(float2 (&w)[R], const float2* tab,
                                                   int idx0, int M) {
  w[1] = twiddle(tab, idx0, M);
  if constexpr (R > 2) {
    w[2] = twiddle(tab, 2 * idx0, M);
    w[3] = cmul(w[1], w[2]);
  }
  if constexpr (R > 4) {
    w[4] = twiddle(tab, 4 * idx0, M);
    w[5] = cmul(w[1], w[4]);
    w[6] = cmul(w[2], w[4]);
    w[7] = cmul(w[3], w[4]);
  }
}

// One Stockham pass of radix R over nf frames: sub-transforms of Ns points
// become sub-transforms of Ns R points. Butterfly j of a frame reads points
// j + r M/R, twiddles them by e^{-2 pi i r (j mod Ns) / (Ns R)} (none in the
// first pass, Ns = 1) and writes points (j - j mod Ns) R + j mod Ns + r Ns.
template <int R>
__device__ void radix_pass(const float2* __restrict__ src, float2* __restrict__ dst,
                           const float2* tab, int nf, int M, int Ns) {
  const int per = M / R, lg_per = __ffs(per) - 1, FS = frame_stride(M);
  const int step = 2 * M / (Ns * R);  // table stride of e^{-2 pi i / (Ns R)}
  for (int bf = threadIdx.x; bf < nf * per; bf += blockDim.x) {
    const int f = bf >> lg_per, j = bf & (per - 1), t = j & (Ns - 1);
    const float2* s = src + f * FS;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[pad(j + r * per)];
    if (Ns > 1) {
      float2 w[R];
      butterfly_twiddles(w, tab, t * step, M);
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], w[r]);
    }
    dft(v);
    float2* d = dst + f * FS;
    const int base = (j - t) * R + t;
#pragma unroll
    for (int r = 0; r < R; ++r) d[pad(base + r * Ns)] = v[r];
  }
}

// stft_mag's first pass (radix 8, Ns = 1: no twiddles), reading its points
// from the staged hop rows: point m of frame f is x[2m] w[2m] + i x[2m+1]
// w[2m+1] of hop[f N_s ..], zero past N_d (the frame's zero padding to K).
__device__ void first_pass_from_hops(const float* hop, const float* w, float2* dst, int nf,
                                     int M, int N_s) {
  const int per = M / 8, lg_per = __ffs(per) - 1, FS = frame_stride(M), N_d = 2 * N_s;
  for (int bf = threadIdx.x; bf < nf * per; bf += blockDim.x) {
    const int f = bf >> lg_per, j = bf & (per - 1);
    const float* fr = hop + f * N_s;
    float2 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = 2 * (j + r * per);
      v[r] = n < N_d ? make_float2(fr[n] * w[n], fr[n + 1] * w[n + 1]) : make_float2(0.f, 0.f);
    }
    dft(v);
    float2* d = dst + f * FS;
#pragma unroll
    for (int r = 0; r < 8; ++r) d[pad(8 * j + r)] = v[r];
  }
}

// The passes of the forward M-point FFT of nf frames from sub-transforms of
// Ns points on, in buffer a (b is scratch); returns the buffer that holds
// the result, in natural order.
__device__ float2* fft_passes(float2* a, float2* b, const float2* tab, int nf, int M,
                              int Ns = 1) {
  for (; Ns < M;) {
    const int R = min(8, M / Ns);
    if (R == 8)
      radix_pass<8>(a, b, tab, nf, M, Ns);
    else if (R == 4)
      radix_pass<4>(a, b, tab, nf, M, Ns);
    else
      radix_pass<2>(a, b, tab, nf, M, Ns);
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    Ns *= R;
  }
  return a;
}

// Float offset of p within its 16 bytes.
__device__ __forceinline__ int misalign(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// n floats of device memory at src into shared memory at dst + misalign(src)
// (dst 16-byte aligned), the aligned middle as float4. Returns the offset.
__device__ int load_flat(const float* __restrict__ src, float* dst, int n) {
  const int a = misalign(src), head = min(n, (4 - a) & 3), n4 = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[a + i] = __ldg(src + i);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + a + head);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = __ldg(s4 + i);
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x) dst[a + i] = __ldg(src + i);
  return a;
}

// The converse: n floats staged at src + misalign(dst) to device memory.
__device__ void store_flat(float* __restrict__ dst, const float* src, int n) {
  const int a = misalign(dst), head = min(n, (4 - a) & 3), n4 = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[a + i];
  const float4* s4 = reinterpret_cast<const float4*>(src + a + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[a + i];
}

// Shared memory, in floats, of each kernel: the twiddle table, a window and
// two FFT buffers (stft_mag stages its hop rows in the second, free until the
// second pass: (F + 1) N_s + 4 <= 2 F (M + M/16) floats for M >= 32; both
// stage their output in the one the result is not in).
int mag_smem_floats(int N_s, int K, int F) {
  const int M = K / 2;
  return round4(2 * (M + 1)) + round4(2 * N_s) + 4 * F * frame_stride(M);
}

int frames_smem_floats(int N_d, int K, int F) {
  const int M = K / 2;
  return round4(2 * (M + 1)) + round4(N_d) + 4 * F * frame_stride(M);
}

// CTA (frame run blockIdx.x, batch row blockIdx.y): frames t0 .. t0+nf-1.
__global__ void __launch_bounds__(MAX_THREADS)
stft_mag_kernel(const float* __restrict__ x2d, const float* __restrict__ win,
                const float2* __restrict__ tw, float* __restrict__ out, int T, int N_s,
                int K, int F) {
  extern __shared__ float4 smem4[];
  const int M = K / 2, nb = M + 1, N_d = 2 * N_s, FS = frame_stride(M);
  float* sm = reinterpret_cast<float*>(smem4);
  float2* tab = reinterpret_cast<float2*>(sm);
  float* w = sm + round4(2 * (M + 1));
  float2* buf0 = reinterpret_cast<float2*>(w + round4(N_d));
  float2* buf1 = buf0 + F * FS;
  float* hop = reinterpret_cast<float*>(buf1);
  const int b = blockIdx.y, t0 = blockIdx.x * F, nf = min(F, T - t0);
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i <= M; i += nt) tab[i] = __ldg(tw + i);
  for (int i = tid; i < N_d; i += nt) w[i] = __ldg(win + i);
  // hop rows t0 .. t0 + nf, one run: frame f's sample n is hop[a + f N_s + n]
  const int a = load_flat(x2d + ((size_t)b * (T + 1) + t0) * N_s, hop, (nf + 1) * N_s);
  __syncthreads();
  first_pass_from_hops(hop + a, w, buf0, nf, M, N_s);
  __syncthreads();
  const float2* Z = fft_passes(buf0, buf1, tab, nf, M, 8);

  // split: X[k] = Fe + W^k Fo and X[M-k] = conj(Fe - W^k Fo), with
  // Fe = (Z[k] + conj Z[M-k]) / 2, Fo = -i (Z[k] - conj Z[M-k]) / 2
  float* mag = reinterpret_cast<float*>(Z == buf0 ? buf1 : buf0);
  float* o = out + ((size_t)b * T + t0) * nb;
  const int ao = misalign(o), half = M / 2 + 1;
  for (int f = 0, k = tid;; k += nt) {  // items (f, k) of nf rows of `half`
    for (; k >= half; k -= half) ++f;
    if (f >= nf) break;
    const float2 A = Z[f * FS + pad(k)], Bc = cconj(Z[f * FS + pad((M - k) & (M - 1))]);
    const float2 Fe = make_float2(0.5f * (A.x + Bc.x), 0.5f * (A.y + Bc.y));
    const float2 D = sub(A, Bc);
    const float2 WFo = cmul(tab[k], make_float2(0.5f * D.y, -0.5f * D.x));
    const float2 X = add(Fe, WFo), Xm = sub(Fe, WFo);
    float* row = mag + ao + f * nb;
    row[k] = sqrtf(X.x * X.x + X.y * X.y);
    if (k != M - k) row[M - k] = sqrtf(Xm.x * Xm.x + Xm.y * Xm.y);
  }
  __syncthreads();
  store_flat(o, mag, nf * nb);
}

// CTA blockIdx.x: rows r0 .. r0+nf-1 of the flat [B T] frames.
__global__ void __launch_bounds__(MAX_THREADS)
enhance_frames_kernel(const float* __restrict__ Y, const float* __restrict__ G,
                      const float* __restrict__ wsyn, const float2* __restrict__ tw,
                      float* __restrict__ out, int rows, int N_d, int K, int F) {
  extern __shared__ float4 smem4[];
  const int M = K / 2, nb = M + 1, FS = frame_stride(M);
  float* sm = reinterpret_cast<float*>(smem4);
  float2* tab = reinterpret_cast<float2*>(sm);
  float* ws = sm + round4(2 * (M + 1));
  float2* buf0 = reinterpret_cast<float2*>(ws + round4(N_d));
  float2* buf1 = buf0 + F * FS;
  const int r0 = blockIdx.x * F, nf = min(F, rows - r0);
  const int tid = threadIdx.x, nt = blockDim.x, lg_M = __ffs(M) - 1;
  const float inv_k = 1.f / K;  // a power of two: exact

  for (int i = tid; i <= M; i += nt) tab[i] = __ldg(tw + i);
  for (int i = tid; i < N_d; i += nt) ws[i] = __ldg(wsyn + i) * inv_k;
  __syncthreads();

  // inverse pre-step on the gained spectrum Xg: with E = Xg[k] + conj Xg[M-k],
  // D = Xg[k] - conj Xg[M-k] and Q = i D conj(W^k), Z[k] = E + Q and
  // Z[M-k] = conj(E - Q); the passes take conj Z (inverse by conjugation)
  const int half = M / 2 + 1;
  for (int f = 0, k = tid;; k += nt) {  // items (f, k) of nf rows of `half`
    for (; k >= half; k -= half) ++f;
    if (f >= nf) break;
    const float* y = Y + (size_t)(r0 + f) * 2 * nb;  // re, then im
    const float* g = G + (size_t)(r0 + f) * nb;
    const float ga = __ldg(g + k), gb = __ldg(g + M - k);
    const float2 Xa = make_float2(ga * __ldg(y + k), k == 0 ? 0.f : ga * __ldg(y + nb + k));
    const float2 Xb = make_float2(gb * __ldg(y + M - k), k == 0 ? 0.f : gb * __ldg(y + nb + M - k));
    const float2 E = add(Xa, cconj(Xb)), D = sub(Xa, cconj(Xb));
    const float2 Q = cmul(make_float2(-D.y, D.x), cconj(tab[k]));
    buf0[f * FS + pad(k)] = cconj(add(E, Q));
    if (k != 0 && k != M - k) buf0[f * FS + pad(M - k)] = sub(E, Q);
  }
  __syncthreads();
  const float2* Z = fft_passes(buf0, buf1, tab, nf, M);

  // z[m] = conj(Z[m]) / K = x[2m] + i x[2m+1]; the first N_d samples times
  // the window, staged in the free buffer (F N_d + 4 <= 2 F (M + M/16) floats)
  float* o = out + (size_t)r0 * N_d;
  const int ao = misalign(o);
  float* stage = reinterpret_cast<float*>(Z == buf0 ? buf1 : buf0);
  for (int i = tid; i < nf * M; i += nt) {
    const int f = i >> lg_M, m = i & (M - 1), n = 2 * m;
    if (n >= N_d) continue;
    const float2 z = Z[f * FS + pad(m)];
    stage[ao + f * N_d + n] = z.x * ws[n];
    stage[ao + f * N_d + n + 1] = -z.y * ws[n + 1];
  }
  __syncthreads();
  store_flat(o, stage, nf * N_d);
}

// What both launches check: K a power of two in [64, 4096], 2 N_s <= K, and F
// frames of K/2 points within a CTA's buffers.
bool bad_domain(int N_s, int K, int F) {
  return K < 64 || K > 4096 || (K & (K - 1)) || N_s < 1 || 2 * N_s > K || F < 1
         || F * (K / 2) > MAX_POINTS;
}

int threads(int K, int F) { return F * (K / 2) / 8 < 32 ? 32 : F * (K / 2) / 8; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// out [B, T, K/2+1] = |rfft_K(hamming(N_d) frame)| of x2d [B, T+1, N_s],
// N_d = 2 N_s, F frames a CTA; win [N_d], tw [K/2+1] complex. Returns 0 or
// the CUDA error of the launch.
int stft_mag_forward(const void* x2d, const void* win, const void* tw, void* out, int B,
                     int T, int N_s, int K, int F, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || bad_domain(N_s, K, F)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * mag_smem_floats(N_s, K, F);
  cudaError_t e = allow_smem(stft_mag_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + F - 1) / F, B);
  stft_mag_kernel<<<grid, threads(K, F), smem, (cudaStream_t)stream>>>(
      (const float*)x2d, (const float*)win, (const float2*)tw, (float*)out, T, N_s, K, F);
  return (int)cudaGetLastError();
}

// out [rows, N_d] = wsyn * irfft_K(G [rows, K/2+1] * (Y re + i Y im))[:N_d]
// for Y [rows, 2 (K/2+1)], F rows a CTA; wsyn [N_d], tw [K/2+1] complex.
// Returns 0 or the CUDA error of the launch.
int enhance_frames_forward(const void* Y, const void* G, const void* wsyn, const void* tw,
                           void* out, int rows, int N_d, int K, int F, void* stream) {
  if (rows < 1 || N_d % 2 || bad_domain(N_d / 2, K, F)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * frames_smem_floats(N_d, K, F);
  cudaError_t e = allow_smem(enhance_frames_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  enhance_frames_kernel<<<(rows + F - 1) / F, threads(K, F), smem, (cudaStream_t)stream>>>(
      (const float*)Y, (const float*)G, (const float*)wsyn, (const float2*)tw, (float*)out,
      rows, N_d, K, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
