// The backward of the dense flash attention (flash_prefill.cu), for Hopper:
// dQ, dK and dV of ops.flash_attention. The kernels live here; two
// translation units instantiate them, one an element type, so that their
// builds run in parallel: flash_prefill_bwd.cu (bf16) and
// flash_prefill_bwd_f32.cu (f32).
//
// Replaces: no TPU kernel. src/repro/kernels/flash_prefill.py
// flash_prefill_kernel has no backward; the JAX package trains through
// gqa_attention (src/repro/models/layers.py:94-116), whose gradient XLA
// derives from the einsums under jax.value_and_grad
// (src/repro/training/train_loop.py:96). This kernel is the port's
// counterpart of that gradient, so that training never materialises the
// [B, H, Sq, Sk] logits.
//
// Function: with the scaled logits r = q k^T * scale, s = c tanh(r / c)
// under a soft cap c > 0 (else s = r), the forward's mask (column j is
// allowed for a query at p iff 0 <= p - j < window and j < kv_len[b]),
// P = softmax(s) in f32 and D = rowsum(dO * O):
//   dV = P^T dO,  dS = P (dO V^T - D) (1 - tanh^2(r / c)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// dK and dV summed over the G query heads of each KV head. Masked pairs
// contribute exactly zero. ref.flash_attention_bwd_ref is the plain version.
//
// What bounds it: operations. Five products a pair where the forward has
// two (S, dP, dQ, dK, dV): 2.5 x the forward's, 0.35 ms in bf16 at a
// Qwen3-4B training layer (q [1,4096,32,128] causal) on the tensor cores'
// 989 TFLOP/s. This design does more than that: S is recomputed in both
// kernels and once more for each row's log-sum-exp (the forward writes
// none), P and dS enter their products as two bf16 terms, and in f32
// every product is three TF32 products. Its rate is mma.sync's, not
// wgmma's. See PERF.md.
//
// Design: the forward's tile skeleton and product policies
// (prefill_attn.cuh: Bf16Op, mma.sync.m16n8k16 on ldmatrix fragments;
// Tf32Op, split-TF32 mma.sync.m16n8k8), deterministic (no atomics, fixed
// summation orders: two calls give the same bits). Two kernels on the
// caller's stream (dkv_kernel launched twice in f32 at head dim 256, once
// for dV and once for dK), each with a two-stage cp.async ring of tiles
// in their own type (rows padded by 16 bytes; rows past the storage
// zero-filled; unaligned operands staged with plain loads into the same
// layout, so the same bits). Every score lives in the m16n8 accumulator
// layout: lane l of a warp holds rows l / 4 and l / 4 + 8 and, of each
// 8-column slice, columns 2 (l % 4) and + 1.
//   dq_kernel, one block per (64-row query tile, query head, batch row),
//     4 warps of 16 rows. Q and dO are A operands for the whole loop (in
//     registers in bf16 up to head dim 128, else in shared memory), D of
//     each row is summed from dO and O. A first sweep over the K tiles
//     the tile can see computes S = Q K^T and each row's log-sum-exp (in
//     base 2: P = 2^(s log2(e) - lse), one FFMA and the SFU's exp2 an
//     element); a second over K and V tiles computes S and dP = dO V^T,
//     forms P and dS in registers, and accumulates dQ += dS K with dS as
//     A fragments (as the forward feeds P to P V) and K as B fragments
//     (ldmatrix.trans in bf16). It writes dQ, and the LSE and D of its
//     rows to the f32 scratch the wrapper allocates.
//   dkv_kernel, one block per (64-key tile, KV head, batch row), each warp
//     owning 16 keys. K and V stay resident in shared memory as the A
//     operands. The block lists the query tiles that can see its keys and
//     walks them, and for each the G query heads, in that fixed order,
//     their Q and dO tiles (and LSE, D and positions) through the ring.
//     Per step S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T land in the
//     accumulator layout and feed dV += P^T dO and dK += dS^T Q as A
//     fragments straight from registers, with dO and Q as B fragments.
//     LSE, D and positions index the n dimension there: read per column
//     pair from the stage. Uncapped, dP^T is formed after dV's product
//     (fewer registers live; formed before it, that instance spilled).
//   In both kernels a tile pair whose every pair is allowed (all the
//   band's interior under a causal mask) skips the mask.
//   The scale is folded into dS before its products; f32 results are
//   rounded to the input type once.
// Numerics as the forward's: in bf16, P and dS enter the products as hi =
// bf16(x) and lo = bf16(x - hi) (about 16 bits of the f32 values survive);
// in f32 every operand is split TF32 hi + lo, and each k-step of every
// product goes into a fresh fragment added in f32 (Tf32Op's kFresh, as
// the forward's capped scores; see scores() below for why).
// Registers (no instance spills; the build's ptxas report): the warps of
// a row (key) group compute the same scores and each accumulates its share
// of the output columns, as the forward does at head dim 256: two warps a
// group at head dim 256, in f32, and in dkv_kernel's capped bf16 instance
// at head dim 128. In f32 at head dims 80 and 112 a warp's share is 40 or
// 56 columns, whose last 8 Tf32Op takes as a half step (kHalf in
// prefill_attn.cuh). A ring stage holds 64 rows in bf16 up to head dim 64
// (dq_kernel's up to 128), 32 above (16 in dkv_kernel's capped instance at
// 256), and 16 in f32, whose score products unroll two k-steps
// (Tf32Op::scores' kSteps). In f32 at head dim 256 dK and dV take a
// dkv_kernel launch each. The heaviest blocks (late query tiles, early
// key tiles under a causal mask) are scheduled first. Instances exist for
// head dims 32, 64, 80, 96, 112, 128 and 256 (ops.HEAD_DIMS); the most
// registers at the new ones are dkv_kernel's capped bf16 instance at 112,
// 255 with no spill.
#pragma once

#include <climits>

#include "prefill_attn.cuh"

namespace bwd {

using prefill::col_split;
constexpr int kRows = prefill::kBQ;  // query rows a dq block, keys a dkv one

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// Warps that share a 16-row (16-key) group, each computing the group's
// scores and accumulating 1 / split of its output columns: the forward's
// col_split (2 at head dim 256), and 2 in f32 (each k-step's products take
// a fresh fragment, whose temporaries spilled beside a warp's full
// accumulators) and in dkv_kernel's capped bf16 instance at head dim 128
// (the cap's factor live beside both score tiles).
template <typename T, int HD, bool kCap, bool kDkv>
__host__ __device__ constexpr int split() {
  return kIsBf16<T> ? (kCap && kDkv && HD == 128 ? 2 : col_split<HD>()) : 2;
}

template <typename T, int HD, bool kCap, bool kDkv>
__host__ __device__ constexpr int threads() {
  return 128 * split<T, HD, kCap, kDkv>();
}

// dkv_kernel's outputs, a bit each: a launch accumulates both, or (f32 at
// head dim 256, where a warp's 2 x 64 accumulators spilled beside the
// fresh fragments) one each in two launches, S^T computed in both
constexpr int kDV = 1, kDK = 2;
template <typename T, int HD>
__host__ __device__ constexpr bool dkv_apart() {
  return !kIsBf16<T> && HD > 128;
}

// rows a ring stage holds (K/V tiles in dq_kernel, Q/dO tiles in
// dkv_kernel): fewer where the accumulators are wide
template <typename T, int HD, bool kCap, bool kDkv>
__host__ __device__ constexpr int stage_rows() {
  return kIsBf16<T> ? (HD <= 64 || (!kDkv && HD <= 128) ? 64
                        : kCap && kDkv && HD > 128      ? 16
                                                        : 32)
                    : 16;
}

// the product policies: K (and V) in dq_kernel and Q (and dO) in
// dkv_kernel are read both as the B operand of a score product and as
// that of an output product, so the f32 tiles take one pitch; dkv_kernel
// reads its A operands (K, V) from shared memory
template <typename T, int HD, bool kCap, bool kDkv>
using OpOf = typename std::conditional<
    kIsBf16<T>,
    prefill::Bf16Op<HD, stage_rows<T, HD, kCap, kDkv>(), !kDkv && HD <= 128,
                    split<T, HD, kCap, kDkv>()>,
    prefill::Tf32Op<HD, stage_rows<T, HD, kCap, kDkv>(), HD + 8,
                    split<T, HD, kCap, kDkv>()>>::type;

// dynamic shared memory of each kernel, bytes: the ring (two tiles a
// stage) and Q, dO (dq_kernel, where they live there) or the resident K,
// V and the ring's LSE, D and positions (dkv_kernel)
template <typename T, int HD, bool kCap>
constexpr int dq_smem() {
  using Op = OpOf<T, HD, kCap, false>;
  return (Op::kStages * 2 * Op::kBK * Op::kPK + 2 * kRows * Op::kPQ) *
         (int)sizeof(T);
}
template <typename T, int HD, bool kCap>
constexpr int dkv_smem() {
  using Op = OpOf<T, HD, kCap, true>;
  return (Op::kStages * 2 * Op::kBK * Op::kPK + 2 * kRows * Op::kPQ) *
             (int)sizeof(T) +
         Op::kStages * 3 * Op::kBK * 4;
}

// n rows [r0, r0 + n) of a [B, Sn, nh, HD] tensor at head hh of batch row
// b into a shared tile of row pitch `pitch` (zeros past Sn), threads i0,
// i0 + stride, ...: 16-byte cp.async copies (the caller commits) when
// every operand is 16-byte aligned, else plain loads
template <typename T, int HD>
__device__ __forceinline__ void stage(T* dst, int pitch,
                                      const T* __restrict__ src, int b,
                                      int r0, int n, int Sn, int nh, int hh,
                                      bool vec, int i0, int stride) {
  constexpr int kVec = 16 / (int)sizeof(T), kWords = HD / kVec;
  if (vec) {
    for (int idx = i0; idx < n * kWords; idx += stride) {
      const int j = idx / kWords, w = idx % kWords, r = r0 + j;
      const bool have = r < Sn;
      const T* s =
          have ? src + (((long long)b * Sn + r) * nh + hh) * HD + kVec * w
               : src;
      cp_async16(dst + j * pitch + kVec * w, s, have);
    }
  } else {
    for (int idx = i0; idx < n * HD; idx += stride) {
      const int j = idx / HD, d = idx % HD, r = r0 + j;
      dst[j * pitch + d] =
          r < Sn ? src[(((long long)b * Sn + r) * nh + hh) * HD + d]
                 : from_f32<T>(0.f);
    }
  }
}

// 4 bytes global -> shared, asynchronously (zeros when fill is false)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

// the allowed rule of the forward (prefill_attn.cuh), causal
__device__ __forceinline__ bool allowed(bool valid, int p, int c, int window,
                                        int klen) {
  const int dl = p - c;
  return valid && dl >= 0 && dl < window && c < klen;
}

// Logits in base 2: the softmax is taken as 2^(x - lse) with x the logit
// times log2(e) (one FFMA and the SFU's exp2 an element) and lse the row's
// log-sum-exp in base 2. log2e_scale = scale log2(e), log2e_cap = c log2(e).
constexpr float kLog2e = 1.4426950408889634f;

// the base-2 logit of a raw product s
template <bool kCap>
__device__ __forceinline__ float logit2(float s, float scale,
                                        float log2e_scale, float softcap,
                                        float log2e_cap) {
  if constexpr (kCap) return log2e_cap * tanhf(s * scale / softcap);
  return s * log2e_scale;
}

// s (the raw product) -> (P, the cap's factor 1 - tanh^2), given the row's
// base-2 log-sum-exp
template <bool kCap>
__device__ __forceinline__ float prob(float s, float scale, float log2e_scale,
                                      float softcap, float log2e_cap,
                                      float lse2, float& dcap) {
  if constexpr (kCap) {
    const float t = tanhf(s * scale / softcap);
    dcap = 1.f - t * t;
    return exp2f(log2e_cap * t - lse2);
  } else {
    dcap = 1.f;
    return exp2f(s * log2e_scale - lse2);
  }
}

// k-steps of an f32 score product unrolled (Tf32Op::scores' kSteps)
constexpr int kScoreSteps = 2;

// The two products of a policy. In f32 each k-step of every product goes
// into a fresh fragment, added to the running one in f32 (Tf32Op's
// kFresh): accumulated in the running fragment, the tensor cores' sums
// lose bits that showed beyond the f32 tolerance in dK and dV (sums over
// every query of G heads, at S 1024) and in dS, whose dP - D cancels
// where the softmax is nearly one-hot (q x 8 under a cap).
// s += A B^T
template <typename Op, int N>
__device__ __forceinline__ void scores(const Op& op, float (&s)[N][4],
                                       const typename Op::T* Bs, int lane) {
  if constexpr (kIsBf16<typename Op::T>)
    op.scores(s, Bs, lane);
  else
    op.template scores<true, kScoreSteps>(s, Bs, lane);
}

// acc += P B, P (the accumulator layout) as A fragments
template <typename Op, int N, int M>
__device__ __forceinline__ void outer(const Op& op, float (&acc)[N][4],
                                      const float (&p)[M][4],
                                      const typename Op::T* Bs, int lane) {
  if constexpr (kIsBf16<typename Op::T>)
    op.pv(acc, p, Bs, lane);
  else
    op.template pv<true>(acc, p, Bs, lane);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// ------------------------------------------------------------- dq_kernel
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(threads<T, HD, kCap, false>(), 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ out,
          const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ lse_out, float* __restrict__ dlt_out,
          const int* __restrict__ q_pos, const int* __restrict__ kv_len,
          int Sq, int Sk, int H, int KV, int window, float scale,
          float softcap, bool vec) {
  using Op = OpOf<T, HD, kCap, false>;
  constexpr int BK = Op::kBK, S = Op::kStages, P = Op::kPK, PQ = Op::kPQ;
  static_assert(Op::kPK == Op::kPV, "K is read by both products");
  constexpr int kThreads = threads<T, HD, kCap, false>();
  constexpr int ND = Op::kOut / 8;       // 8-column slices of a warp's dQ
  constexpr int NS = BK / 8;             // 8-column slices of a score tile
  constexpr int kStage = 2 * BK * P;     // elements a ring stage: K | V
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  T* const qs = ring + S * kStage;       // [kRows][PQ] when PQ > 0
  T* const dos = qs + kRows * PQ;
  __shared__ int s_qmin, s_qmax;

  const int nq = (Sq + kRows - 1) / kRows;
  const int tile = nq - 1 - blockIdx.x;  // the heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % 4, part = warp / 4;  // row group, column half
  const int g = lane >> 2, tg = lane & 3;
  const int rq = tile * kRows;
  const int r0 = rq + rw * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < Sq, v1 = r1 < Sq;
  const long long qb = (long long)b * Sq;
  const int p0 = v0 ? q_pos[qb + r0] : 0, p1 = v1 ? q_pos[qb + r1] : 0;
  const int klen = kv_len ? min(kv_len[b], Sk) : Sk;
  const long long o0 = ((qb + r0) * H + h) * HD, o1 = ((qb + r1) * H + h) * HD;
  const int cq = part * Op::kOut;        // this warp's first dQ column

  if (tid == 0) { s_qmin = INT_MAX; s_qmax = INT_MIN; }
  __syncthreads();
  if (tg == 0 && part == 0) {
    if (v0) { atomicMin(&s_qmin, p0); atomicMax(&s_qmax, p0); }
    if (v1) { atomicMin(&s_qmin, p1); atomicMax(&s_qmax, p1); }
  }
  if constexpr (PQ > 0) {
    // the block's Q and dO rows, one cp.async group (waited for with the
    // first tile); the barrier before the sweeps orders plain stores
    stage<T, HD>(qs, PQ, q, b, rq, kRows, Sq, H, h, vec, tid, kThreads);
    stage<T, HD>(dos, PQ, dout, b, rq, kRows, Sq, H, h, vec, tid, kThreads);
    cp_async_commit();
  }
  Op opq, opd;
  opq.load_q(q, o0, o1, v0, v1, tg, qs + rw * 16 * PQ);
  opd.load_q(dout, o0, o1, v0, v1, tg, dos + rw * 16 * PQ);

  // D = rowsum(dO * O) of rows r0 and r1: lane l % 4 sums dims l % 4 + 4 i,
  // then the 4 lanes of a row add theirs (every lane gets the same bits)
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll 8
  for (int d = tg; d < HD; d += 4) {
    if (v0) dl0 = fmaf(to_f32(dout[o0 + d]), to_f32(out[o0 + d]), dl0);
    if (v1) dl1 = fmaf(to_f32(dout[o1 + d]), to_f32(out[o1 + d]), dl1);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, o);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, o);
  }
  __syncthreads();

  // the KV tiles the q tile can see (the forward's band); a tile whose
  // every pair is allowed (all 64 rows valid, every column within the
  // band of every row) skips the mask
  const int qmin = s_qmin, qmax = s_qmax;
  const long long lo = (long long)qmin - window + 1;
  const int c_lo = lo > 0 ? (int)lo : 0;
  const int c_hi = min(klen, qmax + 1);              // exclusive
  const int t0 = c_lo / BK;
  const int nt = c_hi > t0 * BK ? (c_hi - t0 * BK + BK - 1) / BK : 0;
  const bool rows_full = rq + kRows <= Sq;
  auto full = [&](int c0) {
    return rows_full && c0 + BK - 1 <= qmin &&
           (long long)qmax - c0 < window && c0 + BK <= klen;
  };
  const float log2e_scale = scale * kLog2e, log2e_cap = softcap * kLog2e;

  // one sweep over tiles t0 .. t0 + nt - 1 through the ring: K (and V)
  // of tile t0 + i in slot i % S, the next tile in flight while body(Ks,
  // Vs, c0) runs; group i is always tile t0 + i (empty groups past the end)
  auto sweep = [&](bool with_v, auto&& body) {
    auto fill = [&](int t, int slot) {
      T* const Ks = ring + slot * kStage;
      stage<T, HD>(Ks, P, k, b, t * BK, BK, Sk, KV, kvh, vec, tid, kThreads);
      if (with_v)
        stage<T, HD>(Ks + BK * P, P, v, b, t * BK, BK, Sk, KV, kvh, vec, tid,
                     kThreads);
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < nt) fill(t0 + i, i);
      else cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      if (i + S - 1 < nt) fill(t0 + i + S - 1, (i + S - 1) % S);
      else cp_async_commit();
      cp_async_wait<S - 1>();   // tile t0 + i has landed
      __syncthreads();
      const T* const Ks = ring + (i % S) * kStage;
      const int c0 = (t0 + i) * BK;
      if (full(c0))
        body(std::false_type{}, Ks, Ks + BK * P, c0);
      else
        body(std::true_type{}, Ks, Ks + BK * P, c0);
      __syncthreads();                   // slot i % S is refilled next
    }
    cp_async_wait<0>();
  };

  // sweep 1: each row's base-2 log-sum-exp, from S alone; each lane keeps
  // a running (max, sum) over its columns, and the 4 lanes of a row
  // combine theirs at the end
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  sweep(false, [&](auto masked, const T* Ks, const T*, int c0) {
    float s[NS][4];
    zero(s);
    scores(opq, s, Ks, lane);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = logit2<kCap>(s[j][e], scale, log2e_scale, softcap,
                               log2e_cap);
        if constexpr (decltype(masked)::value) {
          const int c = c0 + 8 * j + 2 * tg + (e & 1);
          if (!(e < 2 ? allowed(v0, p0, c, window, klen)
                      : allowed(v1, p1, c, window, klen)))
            s[j][e] = kNegInf;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      ls0 += exp2f(s[j][0] - mn0) + exp2f(s[j][1] - mn0);
      ls1 += exp2f(s[j][2] - mn1) + exp2f(s[j][3] - mn1);
    }
    l0 = l0 * exp2f(m0 - mn0) + ls0;
    l1 = l1 * exp2f(m1 - mn1) + ls1;
    m0 = mn0;
    m1 = mn1;
  });
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float mo0 = __shfl_xor_sync(0xffffffffu, m0, o);
    const float lo0 = __shfl_xor_sync(0xffffffffu, l0, o);
    const float mo1 = __shfl_xor_sync(0xffffffffu, m1, o);
    const float lo1 = __shfl_xor_sync(0xffffffffu, l1, o);
    const float mn0 = fmaxf(m0, mo0), mn1 = fmaxf(m1, mo1);
    l0 = l0 * exp2f(m0 - mn0) + lo0 * exp2f(mo0 - mn0);
    l1 = l1 * exp2f(m1 - mn1) + lo1 * exp2f(mo1 - mn1);
    m0 = mn0;
    m1 = mn1;
  }
  const float lse0 = m0 + log2f(l0), lse1 = m1 + log2f(l1);

  // sweep 2: S and dP, P and dS in registers, dQ += dS K (scale folded
  // into dS)
  float acc[ND][4];
  zero(acc);
  sweep(true, [&](auto masked, const T* Ks, const T* Vs, int c0) {
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    scores(opq, s, Ks, lane);
    scores(opd, dp, Vs, lane);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dcap;
        const float p = prob<kCap>(s[j][e], scale, log2e_scale, softcap,
                                   log2e_cap, e < 2 ? lse0 : lse1, dcap);
        dp[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * (dcap * scale);
        if constexpr (decltype(masked)::value) {
          const int c = c0 + 8 * j + 2 * tg + (e & 1);
          if (!(e < 2 ? allowed(v0, p0, c, window, klen)
                      : allowed(v1, p1, c, window, klen)))
            dp[j][e] = 0.f;
        }
      }
    }
    outer(opq, acc, dp, Ks + cq, lane);
  });

  opq.store(dq, o0 + cq, o1 + cq, acc, 1.f, 1.f, v0, v1, tg);
  if (part == 0 && tg == 0) {
    const long long st = ((long long)b * H + h) * Sq;
    if (v0) { lse_out[st + r0] = lse0; dlt_out[st + r0] = dl0; }
    if (v1) { lse_out[st + r1] = lse1; dlt_out[st + r1] = dl1; }
  }
}

// ------------------------------------------------------------ dkv_kernel
template <typename T, int HD, bool kCap, int kOuts>
__global__ void __launch_bounds__(threads<T, HD, kCap, true>(), 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           T* __restrict__ dk, T* __restrict__ dv,
           const float* __restrict__ lse_in, const float* __restrict__ dlt_in,
           const int* __restrict__ q_pos, const int* __restrict__ kv_len,
           int Sq, int Sk, int H, int KV, int window, float scale,
           float softcap, bool vec) {
  using Op = OpOf<T, HD, kCap, true>;
  constexpr int BQ = Op::kBK, S = Op::kStages, P = Op::kPK, PR = Op::kPQ;
  static_assert(Op::kPK == Op::kPV, "Q and dO are read by two products");
  constexpr int kThreads = threads<T, HD, kCap, true>();
  constexpr int ND = Op::kOut / 8;       // 8-column slices of dK, dV a warp
  constexpr int NS = BQ / 8;             // 8-query slices of a score tile
  constexpr int kStage = 2 * BQ * P;     // elements a ring stage: Q | dO
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  T* const Kr = ring + S * kStage;       // [kRows][PR], resident
  T* const Vr = Kr + kRows * PR;
  float* const stats = reinterpret_cast<float*>(Vr + kRows * PR);
  // a stage's stats: LSE [BQ], D [BQ], positions [BQ] (int)
  __shared__ int s_list[kThreads];       // visible query tiles of a chunk
  __shared__ int s_cnt[kThreads / 32];

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = warp % 4, part = warp / 4;  // key group, column half
  const int g = lane >> 2, tg = lane & 3;
  const int c0 = kt * kRows;
  const int key0 = c0 + kg * 16 + g, key1 = key0 + 8;
  const int klen = kv_len ? min(kv_len[b], Sk) : Sk;
  const int c_last = min(c0 + kRows, klen) - 1;  // the last allowed key
  const long long qb = (long long)b * Sq;
  const int cq = part * Op::kOut;        // this warp's first dK, dV column

  // K and V of the key tile, one cp.async group (waited for with the first
  // ring stage); this warp's 16 rows are its A operands
  stage<T, HD>(Kr, PR, k, b, c0, kRows, Sk, KV, kvh, vec, tid, kThreads);
  stage<T, HD>(Vr, PR, v, b, c0, kRows, Sk, KV, kvh, vec, tid, kThreads);
  cp_async_commit();
  Op opk, opv;
  opk.load_q(k, 0, 0, false, false, tg, Kr + kg * 16 * PR);
  opv.load_q(v, 0, 0, false, false, tg, Vr + kg * 16 * PR);
  float ak[kOuts & kDK ? ND : 1][4], av[kOuts & kDV ? ND : 1][4];
  zero(ak);
  zero(av);

  const float log2e_scale = scale * kLog2e, log2e_cap = softcap * kLog2e;
  const int nq = c0 < klen ? (Sq + BQ - 1) / BQ : 0;
  for (int base = 0; base < nq; base += kThreads) {
    // the chunk's query tiles that can see an allowed key of this tile,
    // listed in order (thread i tests tile base + i), each with a flag
    // (bit 30) when every pair of the two tiles is allowed: the mask skipped
    const int t = base + tid;
    bool vis = false;
    int entry = t;
    if (t < nq) {
      int mn = INT_MAX, mx = INT_MIN;
      const int re = min(Sq, (t + 1) * BQ);
      for (int r = t * BQ; r < re; ++r) {
        const int p = q_pos[qb + r];
        mn = min(mn, p);
        mx = max(mx, p);
      }
      vis = mx >= c0 && (long long)mn - c_last < window;
      if ((t + 1) * BQ <= Sq && c0 + kRows - 1 <= mn &&
          (long long)mx - c0 < window && c0 + kRows <= klen)
        entry |= 1 << 30;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, vis);
    if (lane == 0) s_cnt[warp] = __popc(bal);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      off += w < warp ? s_cnt[w] : 0;
      n += s_cnt[w];
    }
    if (vis) s_list[off + __popc(bal & ((1u << lane) - 1u))] = entry;
    __syncthreads();

    // step i: query tile s_list[i / G] at query head kvh G + i % G, its
    // Q, dO, LSE, D and positions in slot i % S
    const int steps = n * G;
    const int* const list = s_list;
    auto fill = [&](int i, int slot) {
      const int r0 = (list[i / G] & ~(1 << 30)) * BQ, h = kvh * G + i % G;
      T* const Qs = ring + slot * kStage;
      stage<T, HD>(Qs, P, q, b, r0, BQ, Sq, H, h, vec, tid, kThreads);
      stage<T, HD>(Qs + BQ * P, P, dout, b, r0, BQ, Sq, H, h, vec, tid,
                   kThreads);
      if (tid < BQ) {
        float* const st = stats + slot * 3 * BQ;
        const int r = r0 + tid;
        const bool have = r < Sq;
        const long long o = ((long long)b * H + h) * Sq + r;
        cp_async4(st + tid, have ? lse_in + o : lse_in, have);
        cp_async4(st + BQ + tid, have ? dlt_in + o : dlt_in, have);
        cp_async4(st + 2 * BQ + tid, have ? q_pos + qb + r : q_pos, have);
      }
      cp_async_commit();
    };
    // S^T = K Q^T, P^T (masked pairs 0), dV += P^T dO; dP^T = V dO^T,
    // dS^T = P^T (dP^T - D) (1 - tanh^2) scale, dK += dS^T Q. Uncapped,
    // dP^T is formed after dV's product (not live while it runs); under a
    // cap both score products come first and the cap's factor is folded
    // into dS^T at once (no array of it kept): the fewer registers each
    auto step = [&](auto masked, const T* Qs, const T* dOs, const float* st,
                    int r0) {
      constexpr bool kDS = kOuts & kDK, kCapDS = kCap && kDS;
      float sT[NS][4], dpT[NS][4];
      zero(sT);
      scores(opk, sT, Qs, lane);
      if constexpr (kCapDS) {
        zero(dpT);
        scores(opv, dpT, dOs, lane);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int qi = 8 * j + 2 * tg;   // this lane's two query columns
        const float2 ls = *reinterpret_cast<const float2*>(st + qi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e & 1;
          float dcap;
          float pr = prob<kCap>(sT[j][e], scale, log2e_scale, softcap,
                                log2e_cap, hi ? ls.y : ls.x, dcap);
          if constexpr (decltype(masked)::value) {
            const int2 ps = *reinterpret_cast<const int2*>(st + 2 * BQ + qi);
            if (!allowed(r0 + qi + hi < Sq, hi ? ps.y : ps.x,
                         e < 2 ? key0 : key1, window, klen))
              pr = 0.f;
          }
          sT[j][e] = pr;
          if constexpr (kCapDS) {
            const float2 dl =
                *reinterpret_cast<const float2*>(st + BQ + qi);
            dpT[j][e] = pr * (dpT[j][e] - (hi ? dl.y : dl.x)) *
                        (dcap * scale);
          }
        }
      }
      if constexpr (kOuts & kDV) outer(opk, av, sT, dOs + cq, lane);
      if constexpr (kDS && !kCap) {
        zero(dpT);
        scores(opv, dpT, dOs, lane);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float2 dl =
              *reinterpret_cast<const float2*>(st + BQ + 8 * j + 2 * tg);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpT[j][e] =
                sT[j][e] * (dpT[j][e] - (e & 1 ? dl.y : dl.x)) * scale;
        }
      }
      if constexpr (kDS) outer(opk, ak, dpT, Qs + cq, lane);
    };
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < steps) fill(i, i);
      else cp_async_commit();
    }
    for (int i = 0; i < steps; ++i) {
      if (i + S - 1 < steps) fill(i + S - 1, (i + S - 1) % S);
      else cp_async_commit();
      cp_async_wait<S - 1>();   // step i has landed
      __syncthreads();
      const T* const Qs = ring + (i % S) * kStage;
      const int e = list[i / G];
      const int r0 = (e & ~(1 << 30)) * BQ;
      if (e >> 30)
        step(std::false_type{}, Qs, Qs + BQ * P, stats + (i % S) * 3 * BQ,
             r0);
      else
        step(std::true_type{}, Qs, Qs + BQ * P, stats + (i % S) * 3 * BQ,
             r0);
      __syncthreads();                   // slot i % S is refilled next
    }
    cp_async_wait<0>();
    __syncthreads();                     // s_list is rebuilt next
  }
  cp_async_wait<0>();

  const long long kb = (long long)b * Sk;
  const long long ok0 = ((kb + key0) * KV + kvh) * HD;
  const long long ok1 = ((kb + key1) * KV + kvh) * HD;
  const bool w0 = key0 < Sk, w1 = key1 < Sk;
  if constexpr (kOuts & kDK)
    opk.store(dk, ok0 + cq, ok1 + cq, ak, 1.f, 1.f, w0, w1, tg);
  if constexpr (kOuts & kDV)
    opk.store(dv, ok0 + cq, ok1 + cq, av, 1.f, 1.f, w0, w1, tg);
}

template <typename T, int HD, bool kCap, int kOuts>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               void* dk, void* dv, const float* lse, const float* dlt,
               const int* q_pos, const int* kv_len, int B, int Sq, int Sk,
               int H, int KV, int window, float scale, float softcap,
               bool vec, cudaStream_t st) {
  const auto kkv = dkv_kernel<T, HD, kCap, kOuts>;
  constexpr int smkv = dkv_smem<T, HD, kCap>();
  const cudaError_t e = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smkv);
  if (e != cudaSuccess) return (int)e;
  kkv<<<dim3((Sk + kRows - 1) / kRows, KV, B), threads<T, HD, kCap, true>(),
        smkv, st>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                    (T*)dk, (T*)dv, lse, dlt, q_pos, kv_len, Sq, Sk, H, KV,
                    window, scale, softcap, vec);
  return (int)cudaGetLastError();
}

template <typename T, int HD, bool kCap>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* dlt, const int* q_pos, const int* kv_len, int B, int Sq,
           int Sk, int H, int KV, int window, float scale, float softcap,
           bool vec, cudaStream_t st) {
  const auto kq = dq_kernel<T, HD, kCap>;
  constexpr int smq = dq_smem<T, HD, kCap>();
  cudaError_t e = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smq);
  if (e != cudaSuccess) return (int)e;
  kq<<<dim3((Sq + kRows - 1) / kRows, H, B), threads<T, HD, kCap, false>(),
       smq, st>>>((const T*)q, (const T*)k, (const T*)v, (const T*)out,
                  (const T*)dout, (T*)dq, lse, dlt, q_pos, kv_len, Sq, Sk, H,
                  KV, window, scale, softcap, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || Sk == 0) return (int)e;
  if constexpr (dkv_apart<T, HD>()) {
    const int r = launch_dkv<T, HD, kCap, kDV>(
        q, k, v, dout, dk, dv, lse, dlt, q_pos, kv_len, B, Sq, Sk, H, KV,
        window, scale, softcap, vec, st);
    if (r) return r;
    return launch_dkv<T, HD, kCap, kDK>(q, k, v, dout, dk, dv, lse, dlt,
                                        q_pos, kv_len, B, Sq, Sk, H, KV,
                                        window, scale, softcap, vec, st);
  } else {
    return launch_dkv<T, HD, kCap, kDV | kDK>(
        q, k, v, dout, dk, dv, lse, dlt, q_pos, kv_len, B, Sq, Sk, H, KV,
        window, scale, softcap, vec, st);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, void* dq, void* dk, void* dv, float* lse,
                 float* dlt, const int* q_pos, const int* kv_len, int B,
                 int Sq, int Sk, int H, int KV, int hd, int window,
                 float scale, float softcap, cudaStream_t st) {
  // every tile operand 16-byte aligned: cp.async, else plain loads
  const bool vec = (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)dout) & 15) == 0;
  switch (hd) {
#define BWD_CASE(d)                                                          \
  case d:                                                                    \
    return softcap > 0.f                                                     \
               ? launch<T, d, true>(q, k, v, out, dout, dq, dk, dv, lse,     \
                                    dlt, q_pos, kv_len, B, Sq, Sk, H, KV,    \
                                    window, scale, softcap, vec, st)         \
               : launch<T, d, false>(q, k, v, out, dout, dq, dk, dv, lse,    \
                                     dlt, q_pos, kv_len, B, Sq, Sk, H, KV,   \
                                     window, scale, softcap, vec, st);
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(96)
    BWD_CASE(112)
    BWD_CASE(128)
    BWD_CASE(256)
#undef BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The C entry of one element type T: kv_len may be null (every batch row
// has Sk valid columns); lse and dlt are f32 [B, H, Sq] scratch; softcap 0
// runs the uncapped instances; a dtype other than T's is refused.
template <typename T>
int entry(const void* q, const void* k, const void* v, const void* out,
          const void* dout, void* dq, void* dk, void* dv, void* lse,
          void* dlt, const int* q_pos, const int* kv_len, int B, int Sq,
          int Sk, int H, int KV, int hd, int window, float scale,
          float softcap, int dtype, void* stream) {
  if (dtype != (kIsBf16<T> ? kBF16 : kF32) || !(softcap >= 0.f) || KV <= 0 ||
      H % KV)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  return launch_typed<T>(q, k, v, out, dout, dq, dk, dv, (float*)lse,
                         (float*)dlt, q_pos, kv_len, B, Sq, Sk, H, KV, hd,
                         window, scale, softcap, (cudaStream_t)stream);
}

}  // namespace bwd
