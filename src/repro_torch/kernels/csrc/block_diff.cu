// Block-sparse diff extraction for Hopper (Diff-Aware Storage, paper §4.3).
//
// Replaces: src/repro/kernels/block_diff.py block_diff_kernel (Pallas grid
// (nb, L) over ONE master/mirror pair and one plane, accumulating the max
// across layers by revisiting the output cell).
//
// What bounds it: bytes — every member's K and V read once (N·L·S·KV·hd·2
// elements), a subtract, an abs and a max per element.
//
// Design: one launch for a whole round family and both planes, a single
// pass over it. The grid is (part, token block b, layer × plane): block
// (p, b, z) takes part p (256 threads × 4 words) of the 16-byte words of
// token block b of one layer and plane, the same words in every member.
// Each thread loads a word of the Master once and compares it with that
// word of up to 8 members at once (8 independent 16-byte loads in flight),
// keeping one running max per member in registers; a family of more than
// 8 walks its members in chunks of 8 and reloads the Master word per
// chunk. The Master's own cell is max |m - m|: 0, or NaN where the Master
// holds a NaN, as in the plain version.
//
// Maxima are kept as the bits of non-negative floats, which order as the
// floats do; fabsf of a NaN is a positive NaN, whose bits exceed +inf's,
// so a NaN in a block wins that block's max as jnp.max's does (fmaxf
// would drop it). A block reduces its threads' maxima (warp reduce, then
// shared memory) and combines them across blocks by atomicMax on those
// bits into the zeroed output: max is exact and order-free, so the result
// is the same bits whatever order the blocks run in.
#include "common.cuh"

namespace block_diff {

constexpr int kThreads = 256;
constexpr int kWords = 4;          // words of one member a thread takes
constexpr int kMembers = 8;        // members a thread compares at once

// max(acc, |x - m|) over the elements of two 16-byte words, as bits.
template <typename T>
__device__ __forceinline__ unsigned absdiff_max(const uint4& x, const uint4& m,
                                                unsigned acc) {
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(T); ++e) {
    const float d = fabsf(word_elem<T>(x, e) - word_elem<T>(m, e));
    acc = max(acc, __float_as_uint(d));
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kernel(const uint4* __restrict__ ks, const uint4* __restrict__ vs,
       unsigned* __restrict__ out, int N, int L, int S, int row_words,
       int bt, int master, int nb) {
  const int b = blockIdx.y, l = blockIdx.z >> 1;
  const int s0 = b * bt;
  const int words = min(bt, S - s0) * row_words;   // of one member's tile
  const int w0 = blockIdx.x * kThreads * kWords;
  if (w0 >= words) return;
  const int w1 = min(words, w0 + kThreads * kWords);
  const size_t member = (size_t)L * S * row_words;
  const uint4* tile = ((blockIdx.z & 1) ? vs : ks) +
                      ((size_t)l * S + s0) * row_words;
  const uint4* mp = tile + master * member;
  __shared__ unsigned red[kThreads / 32][kMembers];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int n0 = 0; n0 < N; n0 += kMembers) {
    const uint4* xp[kMembers];
    unsigned acc[kMembers];
#pragma unroll
    for (int j = 0; j < kMembers; ++j) {
      const int n = n0 + j;
      // the Master, and members past N, compare the Master word with itself
      xp[j] = (n < N && n != master) ? tile + n * member : nullptr;
      acc[j] = 0u;
    }
#pragma unroll 1
    for (int w = w0 + threadIdx.x; w < w1; w += kThreads) {
      const uint4 m = __ldg(mp + w);
      uint4 x[kMembers];
#pragma unroll
      for (int j = 0; j < kMembers; ++j) x[j] = xp[j] ? __ldg(xp[j] + w) : m;
#pragma unroll
      for (int j = 0; j < kMembers; ++j)
        acc[j] = absdiff_max<T>(x[j], m, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kMembers; ++j) {
      const unsigned v = __reduce_max_sync(0xffffffffu, acc[j]);
      if (lane == 0) red[warp][j] = v;
    }
    __syncthreads();
    const int n = n0 + threadIdx.x;
    if (threadIdx.x < kMembers && n < N) {
      unsigned v = 0u;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) v = max(v, red[i][threadIdx.x]);
      if (v) atomicMax(out + (size_t)n * nb + b, v);
    }
    __syncthreads();
  }
}

}  // namespace block_diff

// out: [N, ceil(S / bt)] f32, zeroed by the caller; ks/vs 16-byte aligned
// with rows of `row` elements that fill whole 16-byte words.
extern "C" int block_diff_launch(const void* ks, const void* vs, float* out,
                                 int N, int L, int S, int row, int bt,
                                 int master, int dtype, void* stream) {
  using namespace block_diff;
  const int nb = (S + bt - 1) / bt;
  if (N == 0 || L == 0 || nb == 0) return 0;
  const int esize = dtype == kF32 ? 4 : 2;
  if ((row * esize) % 16 || (size_t)ks % 16 || (size_t)vs % 16)
    return (int)cudaErrorInvalidValue;
  const int row_words = row * esize / 16;
  const int chunk = kThreads * kWords;
  const int parts = (bt * row_words + chunk - 1) / chunk;
  dim3 grid(parts, nb, 2 * L);
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* o = reinterpret_cast<unsigned*>(out);
  if (dtype == kF32) {
    kernel<float><<<grid, kThreads, 0, st>>>(
        (const uint4*)ks, (const uint4*)vs, o, N, L, S, row_words, bt,
        master, nb);
  } else {
    kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const uint4*)ks, (const uint4*)vs, o, N, L, S, row_words, bt,
        master, nb);
  }
  return (int)cudaGetLastError();
}
