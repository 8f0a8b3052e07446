// Collective RoPE alignment for Hopper.
//
// Replaces: src/repro/kernels/rope_align.py rope_align_kernel (the Pallas
// TPU kernel, grid over 128-token tiles of one [S, KV, hd] slab).
//
// What bounds it: bytes. Each element is read once and written once with
// a handful of flops (one sincosf per (token, frequency), four FMAs per
// pair), far below the card's ~295 flop/byte ridge.
//
// Design: one thread per (leading row, token, KV head, i < hd/2) rotates
// the pair (x[i], x[i + hd/2]). A leading axis A (layers, or batch x
// layers) is folded into the grid so ONE launch aligns every layer of the
// shared blocks. Deltas are [D, S] with D dividing A: row a uses delta
// [a / (A / D)] (D = 1 shares one delta row across all layers; D = batch
// gives per-request deltas for the decode tails). The frequency table is
// the wrapper's f32 1/theta^(i/half) — the form the model's RoPE rotates
// with — and sincosf is the accurate one (no --use_fast_math). Threads
// adjacent in i touch adjacent addresses, so both halves' loads and
// stores are coalesced.
#include "common.cuh"

template <typename T>
__global__ void rope_align_kernel(const T* __restrict__ k, T* __restrict__ out,
                                  const int* __restrict__ delta,
                                  const float* __restrict__ inv_freq,
                                  long long total, int rows_per_delta, int S,
                                  int KV, int half) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int i = (int)(t % half);
  long long r = t / half;                 // (a, s, kv) flattened
  const int kv = (int)(r % KV);
  r /= KV;
  const int s = (int)(r % S);
  const long long a = r / S;
  const int dl = delta[(a / rows_per_delta) * S + s];
  float sn, cs;
  sincosf((float)dl * inv_freq[i], &sn, &cs);
  const long long base = ((a * S + s) * KV + kv) * (2LL * half);
  const float x1 = to_f32(k[base + i]);
  const float x2 = to_f32(k[base + half + i]);
  out[base + i] = from_f32<T>(x1 * cs - x2 * sn);
  out[base + half + i] = from_f32<T>(x2 * cs + x1 * sn);
}

extern "C" int rope_align_launch(const void* k, void* out, const int* delta,
                                 const float* inv_freq, int A, int D, int S,
                                 int KV, int hd, int dtype, void* stream) {
  const int half = hd / 2;
  const long long total = (long long)A * S * KV * half;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const int rows_per_delta = A / D;
  if (dtype == kF32) {
    rope_align_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)k, (float*)out, delta, inv_freq, total, rows_per_delta,
        S, KV, half);
  } else {
    rope_align_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)k, (__nv_bfloat16*)out, delta, inv_freq, total,
        rows_per_delta, S, KV, half);
  }
  return (int)cudaGetLastError();
}
