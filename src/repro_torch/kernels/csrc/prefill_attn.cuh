// Flash attention over 32-row KV tiles for many queries, shared by the
// dense (flash_prefill.cu) and the paged (flash_prefill_paged.cu) prefill
// kernels.
//
// One block of 128 threads serves one (64-row q tile, query head, batch
// row). Two threads share a query row, each holding half of q and of the
// accumulator in registers (interleaved float2 pairs, so the pair reads two
// adjacent 8-byte words of a K/V row: no bank conflict, and the 16 rows of
// a warp broadcast). The block loops over 32-row KV tiles of the KV head
// h / G, staged in shared memory as f32 (loaded in 16-byte words where
// the rows are aligned). A tile's 32 scores are computed,
// masked to -2^30, folded into the running (max, sum) at once and applied
// to the accumulator: the recurrence of _softmax_update
// (src/repro/kernels/flash_prefill.py:46-66), in f32. Tiles wholly outside
// the q tile's band [min q_pos - window + 1, max q_pos] (causal) or past
// the allowed columns are never loaded.
//
// Column c sits at position c. A query at position p may see column c iff
// c < rows.len(), p - c < window, and, when causal, p - c >= 0. The two
// kernels differ only in where column c's K/V row lives: a Rows type says,
//
//   int len() const;                                  // allowed columns
//   bool row(int c, const T*& k, const T*& v) const;  // the row's hd values
//       // of this KV head; false for a row past the storage (staged as 0)
//
// Rows are addressed one by one, so tile t of the paged kernel holds the
// same logical rows as tile t of the dense kernel over the gathered KV,
// for any span length and page size: the two compute the same bits.
#pragma once

#include <climits>

#include "common.cuh"

namespace prefill {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // KV rows per shared-memory tile
constexpr int kThreads = 128;

// q and out are [B, Sq, H, HD]; q_pos is [B, Sq] (null: row i sits at
// position i). (tile, h, b) name this block's q tile, query head and batch
// row; rows addresses batch row b at KV head h / (H / KV). vec: every row
// the Rows hand out is 16-byte aligned, so tiles are staged in 16-byte
// words (else element by element; the staged values are the same).
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       T* __restrict__ out,
                                       const int* __restrict__ q_pos,
                                       int tile, int h, int b, int Sq, int H,
                                       int window, bool causal, float scale,
                                       bool vec, const Rows& rows) {
  constexpr int NP = HD / 4;   // float2 pairs held per thread
  __shared__ __align__(16) float Ks[kBK][HD];
  __shared__ __align__(16) float Vs[kBK][HD];
  __shared__ int s_qmin, s_qmax;

  const int tid = threadIdx.x;
  const int part = tid & 1;
  const int row = tile * kBQ + (tid >> 1);
  const bool valid_row = row < Sq;
  const int qp = !valid_row ? 0 : q_pos ? q_pos[(long long)b * Sq + row] : row;
  const int klen = rows.len();

  if (tid == 0) { s_qmin = INT_MAX; s_qmax = INT_MIN; }
  __syncthreads();
  if (valid_row && part == 0) { atomicMin(&s_qmin, qp); atomicMax(&s_qmax, qp); }

  float2 qv[NP], acc[NP];
  const long long qo = (((long long)b * Sq + row) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int d = 4 * i + 2 * part;
    qv[i] = valid_row ? make_float2(to_f32(q[qo + d]), to_f32(q[qo + d + 1]))
                      : make_float2(0.f, 0.f);
    acc[i] = make_float2(0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;
  __syncthreads();

  const long long lo = (long long)s_qmin - window + 1;
  const int c_lo = lo > 0 ? (int)lo : 0;
  const int c_hi = causal ? min(klen, s_qmax + 1) : klen;   // exclusive
  for (int c0 = (c_lo / kBK) * kBK; c0 < c_hi; c0 += kBK) {
    __syncthreads();
    if (vec) {
      // 16-byte words: one row address per word, float4 stores
      constexpr int kVec = 16 / sizeof(T);
      constexpr int kWords = HD / kVec;
      for (int idx = tid; idx < kBK * kWords; idx += kThreads) {
        const int j = idx / kWords, w = idx % kWords;
        const T* kr;
        const T* vr;
        uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
        if (rows.row(c0 + j, kr, vr)) {
          kw = reinterpret_cast<const uint4*>(kr)[w];
          vw = reinterpret_cast<const uint4*>(vr)[w];
        }
        float4* kd = reinterpret_cast<float4*>(&Ks[j][w * kVec]);
        float4* vd = reinterpret_cast<float4*>(&Vs[j][w * kVec]);
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          kd[e / 4] = make_float4(word_elem<T>(kw, e), word_elem<T>(kw, e + 1),
                                  word_elem<T>(kw, e + 2),
                                  word_elem<T>(kw, e + 3));
          vd[e / 4] = make_float4(word_elem<T>(vw, e), word_elem<T>(vw, e + 1),
                                  word_elem<T>(vw, e + 2),
                                  word_elem<T>(vw, e + 3));
        }
      }
    } else {
      for (int idx = tid; idx < kBK * HD; idx += kThreads) {
        const int j = idx / HD, d = idx % HD;
        const T* kr;
        const T* vr;
        const bool have = rows.row(c0 + j, kr, vr);
        Ks[j][d] = have ? to_f32(kr[d]) : 0.f;
        Vs[j][d] = have ? to_f32(vr[d]) : 0.f;
      }
    }
    __syncthreads();

    float s[kBK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float2* kr = reinterpret_cast<const float2*>(Ks[j]);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float2 kk = kr[2 * i + part];
        dot += qv[i].x * kk.x + qv[i].y * kk.y;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const int c = c0 + j;
      const int dl = qp - c;
      const bool ok = valid_row && (!causal || dl >= 0) && dl < window &&
                      c < klen;
      s[j] = ok ? dot * scale : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      lsum += s[j];
    }
    l = alpha * l + lsum;
#pragma unroll
    for (int i = 0; i < NP; ++i) { acc[i].x *= alpha; acc[i].y *= alpha; }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
      const float2* vr = reinterpret_cast<const float2*>(Vs[j]);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float2 vv = vr[2 * i + part];
        acc[i].x += p * vv.x;
        acc[i].y += p * vv.y;
      }
    }
    m = m_new;
  }

  if (valid_row) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int d = 4 * i + 2 * part;
      out[qo + d] = from_f32<T>(acc[i].x * inv);
      out[qo + d + 1] = from_f32<T>(acc[i].y * inv);
    }
  }
}

}  // namespace prefill
