// Collective RoPE alignment for Hopper.
//
// Replaces: src/repro/kernels/rope_align.py rope_align_kernel (the Pallas
// TPU kernel, grid over 128-token tiles of one [S, KV, hd] slab).
//
// What bounds it: bytes. Each element is read once and written once with
// four flops a pair and one sincosf per (delta row, token, frequency), far
// below the card's ~295 flop/byte ridge.
//
// Design: keys [A, S, KV, hd] (a leading axis A of layers, or batch x
// layers) and deltas [D, S], D dividing A: row a uses delta[a / (A / D)].
// Block (token s, delta row d) covers token s of every leading row that
// uses row d. It first computes each angle of its token once —
// sincosf((float)delta * inv_freq[i]), the accurate sincosf (no
// --use_fast_math) of the wrapper's f32 1/theta^(i/half), the form the
// model's RoPE rotates with — into shared memory. Each thread then holds
// the cos and sin of one (KV head, 16-byte word of the first half) in
// registers and walks the leading rows of its delta row, kRows at a time:
// it loads the words x1 at i..i+E-1 and x2 at i + hd/2 of every row of the
// batch (2·kRows loads in flight), then stores x1·cos − x2·sin and x2·cos
// + x1·sin as two words each. Adjacent threads take adjacent words, so
// every access is a full 16-byte word and coalesced. Indices come from
// blockIdx and the thread's fixed place; the only divisions are 32-bit,
// once a thread. The two products are written as the fused multiply-adds
// the first kernel's compiler chose, fma(x1, cos, −x2·sin) and fma(x1,
// sin, x2·cos), so the bits do not depend on how nvcc contracts them.
#include "common.cuh"

namespace rope_align {

constexpr int kThreads = 256;
constexpr int kRows = 4;           // leading rows a thread loads at once

template <typename T, int W>       // W: 16-byte words in half a head
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ k, T* __restrict__ out,
       const int* __restrict__ delta, const float* __restrict__ inv_freq,
       int rows_per_delta, int S, int KV) {
  constexpr int E = 16 / sizeof(T);      // elements a word
  constexpr int HALF = W * E;
  constexpr int HD = 2 * HALF;
  __shared__ float cos_s[HALF], sin_s[HALF];
  const int s = blockIdx.x, d = blockIdx.y;
  if (threadIdx.x < HALF) {
    float sn, cs;
    sincosf((float)delta[d * S + s] * inv_freq[threadIdx.x], &sn, &cs);
    cos_s[threadIdx.x] = cs;
    sin_s[threadIdx.x] = sn;
  }
  __syncthreads();

  // thread -> (KV head, word j) of one leading row, and the phase g of the
  // rows it walks (G rows at once when a row's words fit in the block)
  const int per_row = KV * W;
  const int G = max(1, kThreads / per_row);
  const int g = threadIdx.x / per_row;
  if (g >= G) return;
  const size_t step = (size_t)G * S * KV * HD;   // G leading rows
  for (int e = threadIdx.x % per_row; e < per_row; e += kThreads) {
    const int j = e % W;                   // e / W is the KV head
    float cs[E], sn[E];
#pragma unroll
    for (int c = 0; c < E; ++c) {
      cs[c] = cos_s[j * E + c];
      sn[c] = sin_s[j * E + c];
    }
    const size_t off = ((size_t)(d * rows_per_delta + g) * S + s) * KV * HD +
                       (size_t)(e / W) * HD + j * E;
    const T* src = k + off;
    T* dst = out + off;
    for (int a = g; a < rows_per_delta; a += kRows * G) {
      uint4 w1[kRows], w2[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (a + u * G < rows_per_delta) {
          w1[u] = __ldg(reinterpret_cast<const uint4*>(src + u * step));
          w2[u] = __ldg(reinterpret_cast<const uint4*>(src + u * step + HALF));
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (a + u * G >= rows_per_delta) break;
        uint4 o1, o2;
        T* p1 = reinterpret_cast<T*>(&o1);
        T* p2 = reinterpret_cast<T*>(&o2);
#pragma unroll
        for (int c = 0; c < E; ++c) {
          const float x1 = word_elem<T>(w1[u], c), x2 = word_elem<T>(w2[u], c);
          p1[c] = from_f32<T>(__fmaf_rn(x1, cs[c], -__fmul_rn(x2, sn[c])));
          p2[c] = from_f32<T>(__fmaf_rn(x1, sn[c], __fmul_rn(x2, cs[c])));
        }
        *reinterpret_cast<uint4*>(dst + u * step) = o1;
        *reinterpret_cast<uint4*>(dst + u * step + HALF) = o2;
      }
      src += kRows * step;
      dst += kRows * step;
    }
  }
}

template <typename T>
int launch(const T* k, T* out, const int* delta, const float* inv_freq,
           int rows_per_delta, int D, int S, int KV, int W, cudaStream_t st) {
  dim3 grid(S, D);
  switch (W) {
#define ROPE_CASE(w)                                                   \
  case w:                                                              \
    kernel<T, w><<<grid, kThreads, 0, st>>>(k, out, delta, inv_freq,   \
                                            rows_per_delta, S, KV);    \
    break;
    ROPE_CASE(2)
    ROPE_CASE(4)
    ROPE_CASE(5)
    ROPE_CASE(6)
    ROPE_CASE(7)
    ROPE_CASE(8)
    ROPE_CASE(10)
    ROPE_CASE(12)
    ROPE_CASE(14)
    ROPE_CASE(16)
    ROPE_CASE(32)
#undef ROPE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace rope_align

// k, out [A, S, KV, hd], 16-byte aligned; half a head fills 2, 4, 5, 6,
// 7, 8, 10, 12, 14, 16 or 32 whole 16-byte words (hd 32, 64, 80, 96, 112,
// 128, 256 in both types: 5 and 10 words are hd 80 in bf16 and f32, 6 and
// 12 hd 96, 7 and 14 hd 112; 32 words is f32 at hd 256, whose 128 angles
// a token still take one pass of the block's first 128 threads). The
// kernel takes any W: another head dim needs only its case.
extern "C" int rope_align_launch(const void* k, void* out, const int* delta,
                                 const float* inv_freq, int A, int D, int S,
                                 int KV, int hd, int dtype, void* stream) {
  if ((long long)A * S * KV * hd == 0) return 0;
  const int esize = dtype == kF32 ? 4 : 2;
  if (D <= 0 || A % D || (hd / 2 * esize) % 16 || (size_t)k % 16 ||
      (size_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const int W = hd / 2 * esize / 16;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return rope_align::launch<float>((const float*)k, (float*)out, delta,
                                     inv_freq, A / D, D, S, KV, W, st);
  return rope_align::launch<__nv_bfloat16>(
      (const __nv_bfloat16*)k, (__nv_bfloat16*)out, delta, inv_freq, A / D,
      D, S, KV, W, st);
}
