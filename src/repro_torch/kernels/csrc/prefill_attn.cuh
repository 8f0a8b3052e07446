// Flash attention for many queries, shared by the dense
// (flash_prefill.cu) and the paged (flash_prefill_paged.cu) prefill
// kernels: prefill::attend, one tile function per element type.
//
// One block of 128 threads serves one (64-row q tile, query head, batch
// row) and loops over KV tiles of the KV head h / G. Tiles wholly outside
// the q tile's band [min q_pos - window + 1, max q_pos] (causal) or past
// the allowed columns are never loaded. Each tile's scores are scaled in
// f32 after the product, masked to -2^30, folded into the running (max,
// sum) and applied to the accumulator: the recurrence of _softmax_update
// (src/repro/kernels/flash_prefill.py:46-66), in f32, with the output
// acc / max(l, 1e-30) rounded to T once.
//
// bf16 (attend_mma): on the tensor cores. K/V stay bf16 in shared memory,
// in a ring of two 64-row stages filled by 16-byte cp.async copies, so
// tile t+1 is in flight while tile t is computed (rows past the storage
// are zero-filled by the copy's src-size 0 form; unaligned rows are
// staged with plain loads into the same layout). Rows are padded by 16
// bytes, so the 8 row addresses of every ldmatrix fall in 8 different
// bank groups. Each of the 4 warps owns 16 query rows and keeps their Q
// fragments in registers for the whole KV loop. Q*K^T is
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) on ldmatrix fragments of K;
// P*V is the same mma on ldmatrix.trans fragments of V, with P entering
// as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so about 16 bits
// of the f32 probabilities survive (the TPU kernel multiplies P*V in
// f32). Row max and row sum reduce over the 4 lanes that share a row.
// What bounds it: at [8,544,28,128] causal the bytes bound is 0.021 ms
// and the tensor-core bound 0.017 ms (counting only allowed pairs); the
// kernel does ~1.9x those operations (whole diagonal tiles, two P*V
// products) through mma.sync, at a fraction of the rate wgmma reaches,
// and reads each K/V fragment from shared memory once per 16 query rows.
// mma.sync rather than wgmma: its fragments are plain register layouts
// that ldmatrix fills from a padded tile, where wgmma wants its B tiles
// in a swizzled layout named by shared-memory descriptors. wgmma (one
// warpgroup per 64-row q tile, P from registers) and TMA for the dense
// rows are the next step; the paged rows are gathered one by one, which
// TMA's tiled copies do not express.
//
// f32 (attend_simt): on the CUDA cores, since TF32 products keep ~10
// mantissa bits and would break the f32 tolerance (1e-4). Two threads
// share a query row, each holding half of q and of the accumulator in
// registers (interleaved float2 pairs, so the pair reads two adjacent
// 8-byte words of a K/V row: no bank conflict, and the 16 rows of a warp
// broadcast). 32-row KV tiles are staged in shared memory as f32 (loaded
// in 16-byte words where the rows are aligned); the scores of a tile are
// scalar FMA loops. Bound by f32 FMA issue (0.25 ms of operations at
// [8,544,28,128]).
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
#include <type_traits>

#include "common.cuh"

namespace prefill {

constexpr int kBQ = 64;       // query rows per block
constexpr int kThreads = 128;

// ---------------------------------------------------------------- f32
constexpr int kBK = 32;       // KV rows per shared-memory tile

// q and out are [B, Sq, H, HD]; q_pos is [B, Sq] (null: row i sits at
// position i). (tile, h, b) name this block's q tile, query head and batch
// row; rows addresses batch row b at KV head h / (H / KV). vec: every row
// the Rows hand out is 16-byte aligned, so tiles are staged in 16-byte
// words (else element by element; the staged values are the same).
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend_simt(const T* __restrict__ q,
                                            T* __restrict__ out,
                                            const int* __restrict__ q_pos,
                                            int tile, int h, int b, int Sq,
                                            int H, int window, bool causal,
                                            float scale, bool vec,
                                            const Rows& rows) {
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

// --------------------------------------------------------------- bf16
constexpr int kBKV = 64;      // KV rows per ring stage
constexpr int kStages = 2;

// Dynamic shared memory of the bf16 tile function: kStages x (K, V) x
// kBKV rows of HD + 8 bf16 (16 bytes of padding a row).
template <int HD>
constexpr int mma_smem_bytes() {
  return kStages * 2 * kBKV * (HD + 8) * (int)sizeof(__nv_bfloat16);
}

// Dynamic shared memory a launch of prefill::attend<T, HD> needs.
template <typename T, int HD>
constexpr int smem_bytes() {
  return std::is_same<T, __nv_bfloat16>::value ? mma_smem_bytes<HD>() : 0;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b: one m16n8k16 tile, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two adjacent bf16 of a row as one fragment register (the lower column
// in the low half); 4-byte loads where the row allows them.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p,
                                              bool al4) {
  if (al4) return *reinterpret_cast<const uint32_t*>(p);
  __nv_bfloat162 x;
  x.x = p[0];
  x.y = p[1];
  return pack_bf16(x);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b,
                                           bool al4) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  if (al4) {
    *reinterpret_cast<__nv_bfloat162*>(p) = x;
  } else {
    p[0] = x.x;
    p[1] = x.y;
  }
}

// p as hi + lo, two bf16 fragment registers (columns c, c + 1).
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(p0 - __low2float(h),
                                       p1 - __high2float(h)));
}

// The contract of attend_simt, for bf16, on the tensor cores. Lane l of
// warp w holds query rows r0 = 16 w + l / 4 and r1 = r0 + 8 of the tile
// and, of each 8-column slice of scores and outputs, columns 2 (l % 4)
// and 2 (l % 4) + 1: the m16n8 accumulator layout.
template <int HD, typename Rows>
__device__ __forceinline__ void attend_mma(const __nv_bfloat16* __restrict__ q,
                                           __nv_bfloat16* __restrict__ out,
                                           const int* __restrict__ q_pos,
                                           int tile, int h, int b, int Sq,
                                           int H, int window, bool causal,
                                           float scale, bool vec,
                                           const Rows& rows) {
  using T = __nv_bfloat16;
  constexpr int P = HD + 8;          // shared row pitch, elements
  constexpr int NK = HD / 16;        // k-steps of Q K^T
  constexpr int ND = HD / 8;         // 8-column slices of the output
  constexpr int NS = kBKV / 8;       // 8-column slices of a score tile
  constexpr int kWords = HD / 8;     // 16-byte words a row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // [stage][K, V][kBKV][P]
  __shared__ int s_qmin, s_qmax;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = tile * kBQ + warp * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < Sq, v1 = r1 < Sq;
  const long long qb = (long long)b * Sq;
  const int p0 = !v0 ? 0 : q_pos ? q_pos[qb + r0] : r0;
  const int p1 = !v1 ? 0 : q_pos ? q_pos[qb + r1] : r1;
  const int klen = rows.len();

  if (tid == 0) { s_qmin = INT_MAX; s_qmax = INT_MIN; }
  __syncthreads();
  if (tg == 0) {
    if (v0) { atomicMin(&s_qmin, p0); atomicMax(&s_qmax, p0); }
    if (v1) { atomicMin(&s_qmin, p1); atomicMax(&s_qmax, p1); }
  }

  const long long o0 = ((qb + r0) * H + h) * HD, o1 = ((qb + r1) * H + h) * HD;
  const bool qal = (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  uint32_t qf[NK][4];
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const int c = 16 * ks + 2 * tg;
    qf[ks][0] = v0 ? load_pair(q + o0 + c, qal) : 0u;
    qf[ks][1] = v1 ? load_pair(q + o1 + c, qal) : 0u;
    qf[ks][2] = v0 ? load_pair(q + o0 + c + 8, qal) : 0u;
    qf[ks][3] = v1 ? load_pair(q + o1 + c + 8, qal) : 0u;
  }
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: this lane's
  __syncthreads();

  const long long lo = (long long)s_qmin - window + 1;
  const int c_lo = lo > 0 ? (int)lo : 0;
  const int c_hi = causal ? min(klen, s_qmax + 1) : klen;   // exclusive
  const int t0 = c_lo / kBKV;
  const int nt = c_hi > t0 * kBKV ? (c_hi - t0 * kBKV + kBKV - 1) / kBKV : 0;

  // stage tile t into ring slot s, as one cp.async group
  auto stage = [&](int t, int s) {
    T* const Ks = ring + s * 2 * kBKV * P;
    T* const Vs = Ks + kBKV * P;
    const int c0 = t * kBKV;
    if (vec) {
      static_assert(kBKV * kWords % kThreads == 0, "whole words a thread");
#pragma unroll
      for (int it = 0; it < kBKV * kWords / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        const int j = idx / kWords, w = idx % kWords;
        const T* kr;
        const T* vr;
        const bool have = rows.row(c0 + j, kr, vr);
        cp_async16(Ks + j * P + 8 * w, have ? kr + 8 * w : q, have);
        cp_async16(Vs + j * P + 8 * w, have ? vr + 8 * w : q, have);
      }
    } else {
      const T zero = __ushort_as_bfloat16((unsigned short)0);
      for (int idx = tid; idx < kBKV * HD; idx += kThreads) {
        const int j = idx / HD, d = idx % HD;
        const T* kr;
        const T* vr;
        const bool have = rows.row(c0 + j, kr, vr);
        Ks[j * P + d] = have ? kr[d] : zero;
        Vs[j * P + d] = have ? vr[d] : zero;
      }
    }
    cp_async_commit();
  };

  if (nt > 0) stage(t0, 0);
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) stage(t0 + i + 1, (i + 1) & 1);
    else cp_async_commit();             // an empty group keeps the count
    cp_async_wait<1>();                 // tile t0 + i has landed
    __syncthreads();
    const T* const Ks = ring + (i & 1) * 2 * kBKV * P;
    const T* const Vs = Ks + kBKV * P;
    const int c0 = (t0 + i) * kBKV;

    // S = Q K^T over the tile's 64 columns
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (16 * np + (lane >> 4) * 8 + (lane & 7)) * P +
                            16 * ks + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, mask, and the row maxima over the 4 lanes of a row
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * j + 2 * tg + (e & 1);
        const int dl = (e < 2 ? p0 : p1) - c;
        const bool ok = (e < 2 ? v0 : v1) && (!causal || dl >= 0) &&
                        dl < window && c < klen;
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l0 = a0 * l0 + ls0;
    l1 = a1 * l1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= a0;
      acc[d][1] *= a0;
      acc[d][2] *= a1;
      acc[d][3] *= a1;
    }

    // O += P V, P as hi + lo
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (16 * kk + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * P +
                                  16 * dp + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                    // slot i & 1 is refilled next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const bool oal = (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int c = 8 * d + 2 * tg;
    if (v0) store_pair(out + o0 + c, acc[d][0] / d0, acc[d][1] / d0, oal);
    if (v1) store_pair(out + o1 + c, acc[d][2] / d1, acc[d][3] / d1, oal);
  }
}

// The tile function of both prefill kernels: the tensor-core path for
// bf16, the CUDA-core path for f32. A bf16 launch passes
// smem_bytes<T, HD>() of dynamic shared memory.
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       T* __restrict__ out,
                                       const int* __restrict__ q_pos,
                                       int tile, int h, int b, int Sq, int H,
                                       int window, bool causal, float scale,
                                       bool vec, const Rows& rows) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    attend_mma<HD>(q, out, q_pos, tile, h, b, Sq, H, window, causal, scale,
                   vec, rows);
  else
    attend_simt<T, HD>(q, out, q_pos, tile, h, b, Sq, H, window, causal,
                       scale, vec, rows);
}

}  // namespace prefill
