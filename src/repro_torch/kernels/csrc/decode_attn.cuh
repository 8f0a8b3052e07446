// Single-query decode attention over 32-row KV tiles, shared by the dense
// (flash_decode.cu) and the paged (flash_decode_paged.cu) decode kernels.
//
// One block of 128 threads serves one (KV head, sequence) pair and the G
// query heads that share that KV head (G <= 8), so each KV row is read
// from device memory once per group, not once per query head. The block
// walks KV tiles t_begin .. t_end-1 in order. A tile (32 rows, one per
// lane of a warp) is loaded in 16-byte words (each thread asks its Rows
// for a row's address once per word it loads, not once per element) and
// staged in shared memory as f32 with a padded row stride (hd + 1) so the
// per-key dot products of a warp hit 32 different banks. Scores for the G x 32 (head, key) pairs are computed one pair per
// thread and masked to -2^30; one warp per head folds them into the
// running (max, sum) of the online softmax with shuffles (the recurrence
// of _softmax_update, src/repro/kernels/flash_prefill.py:46-66, in f32);
// then the G x hd accumulator in shared memory is rescaled and updated.
//
// The two kernels differ only in where tile t's row j lives and which of
// its columns are allowed: a Rows type supplies both,
//
//   bool row(int t, int j, const T*& k, const T*& v) const;
//       // point k/v at the row's hd values of this KV head (16-byte
//       // aligned); false for a row past the storage (staged as zeros)
//   bool valid(int t, int j) const;   // the column is allowed
//
// so the arithmetic on a tile is one piece of code: the dense and paged
// kernels compute the same bits whenever their tiles hold the same rows
// under the same masks (the port's paged == dense contract on the card).
#pragma once

#include "common.cuh"

namespace decode {

constexpr int kBT = 32;       // KV rows per tile == warp width == page rows
constexpr int kMaxG = 8;      // query heads per KV head
constexpr int kThreads = 128;

// q and out are [B, H, HD]; b and kvh name this block's sequence and KV
// head. Tiles [t_begin, t_end) are visited; an empty range writes zeros.
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       T* __restrict__ out, int b, int kvh,
                                       int H, int KV, float scale,
                                       int t_begin, int t_end,
                                       const Rows& rows) {
  __shared__ float qs[kMaxG][HD];
  __shared__ float Ks[kBT][HD + 1];
  __shared__ float Vs[kBT][HD + 1];
  __shared__ float ps[kMaxG][kBT];
  __shared__ float acc[kMaxG][HD];
  __shared__ float m_s[kMaxG], l_s[kMaxG], a_s[kMaxG];

  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    qs[g][d] = to_f32(q[((long long)b * H + kvh * G + g) * HD + d]);
    acc[g][d] = 0.f;
  }
  if (tid < G) { m_s[tid] = kNegInf; l_s[tid] = 0.f; }

  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte word
  constexpr int kWords = HD / kVec;      // words per row
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();
    for (int idx = tid; idx < kBT * kWords; idx += kThreads) {
      const int j = idx / kWords, w = idx % kWords;
      const T* kr;
      const T* vr;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
      if (rows.row(t, j, kr, vr)) {
        kw = reinterpret_cast<const uint4*>(kr)[w];
        vw = reinterpret_cast<const uint4*>(vr)[w];
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        Ks[j][w * kVec + e] = word_elem<T>(kw, e);
        Vs[j][w * kVec + e] = word_elem<T>(vw, e);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * kBT; idx += kThreads) {
      const int g = idx / kBT, j = idx % kBT;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += qs[g][d] * Ks[j][d];
      ps[g][j] = rows.valid(t, j) ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      const float x = ps[g][lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = expf(x - m_new);
      const float sum = warp_sum(p);
      ps[g][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * HD; idx += kThreads) {
      const int g = idx / HD, d = idx % HD;
      float a = acc[g][d] * a_s[g];
#pragma unroll 8
      for (int j = 0; j < kBT; ++j) a += ps[g][j] * Vs[j][d];
      acc[g][d] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    out[((long long)b * H + kvh * G + g) * HD + d] =
        from_f32<T>(acc[g][d] / fmaxf(l_s[g], 1e-30f));
  }
}

}  // namespace decode
