// Block-sparse diff extraction for Hopper (Diff-Aware Storage, paper §4.3).
//
// Replaces: src/repro/kernels/block_diff.py block_diff_kernel (Pallas grid
// (nb, L) over ONE master/mirror pair and one plane, accumulating the max
// across layers by revisiting the output cell).
//
// What bounds it: bytes — two loads, a subtract, an abs and a max per
// element of every member's K and V.
//
// Design: one launch for a whole round family and both planes. The grid is
// (nb, N): block (b, n) reduces max |x[n] - x[master]| over every layer,
// every token of block b, every KV head and head dim, for K and for V, and
// writes one f32 to out[n, nb]. There is no cross-block state, so the
// layer reduction the TPU kernel carried in its output cell happens inside
// the block (a strided loop, then warp shuffles and shared memory).
// Within one (n, l) the block's tokens are contiguous, so threads walk
// them in address order and every load is coalesced. The master's own row
// reads nothing and writes 0.
#include "common.cuh"

template <typename T>
__global__ void block_diff_kernel(const T* __restrict__ ks, const T* __restrict__ vs,
                                  float* __restrict__ out, int L, int S,
                                  int row, int bt, int master) {
  const int b = blockIdx.x, n = blockIdx.y, nb = gridDim.x;
  __shared__ float red[32];
  float m = 0.0f;
  if (n != master) {
    const int s0 = b * bt;
    const int nt = min(bt, S - s0);
    const long long span = (long long)nt * row;   // elements per layer
    for (int l = 0; l < L; ++l) {
      const long long xo = (((long long)n * L + l) * S + s0) * row;
      const long long mo = (((long long)master * L + l) * S + s0) * row;
      for (long long e = threadIdx.x; e < span; e += blockDim.x) {
        const float dk = fabsf(to_f32(ks[xo + e]) - to_f32(ks[mo + e]));
        const float dv = fabsf(to_f32(vs[xo + e]) - to_f32(vs[mo + e]));
        m = fmaxf(m, fmaxf(dk, dv));
      }
    }
  }
  m = warp_max(m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    float x = lane < nw ? red[lane] : 0.0f;
    x = warp_max(x);
    if (lane == 0) out[(long long)n * nb + b] = x;
  }
}

extern "C" int block_diff_launch(const void* ks, const void* vs, float* out,
                                 int N, int L, int S, int row, int bt,
                                 int master, int dtype, void* stream) {
  const int nb = (S + bt - 1) / bt;
  if (N == 0 || nb == 0) return 0;
  dim3 grid(nb, N);
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    block_diff_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)ks, (const float*)vs, out, L, S, row, bt, master);
  } else {
    block_diff_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs, out, L, S, row,
        bt, master);
  }
  return (int)cudaGetLastError();
}
