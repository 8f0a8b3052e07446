// Flash attention for many queries, shared by the dense
// (flash_prefill.cu) and the paged (flash_prefill_paged.cu) prefill
// kernels: prefill::attend, one tile function on the tensor cores for
// both element types, with a product policy per type.
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
// The skeleton (attend_tc): K/V stay in their own type in shared memory,
// in a ring of kStages tiles of kBK rows filled by 16-byte cp.async
// copies, so the next tile is in flight while one is computed (rows past
// the storage are zero-filled by the copy's src-size 0 form; unaligned
// rows are staged with plain loads into the same layout). Each of the 4
// warps owns 16 query rows and keeps their Q for the whole KV loop. Lane
// l of warp w holds query rows r0 = 16 w + l / 4 and r1 = r0 + 8 and, of
// each 8-column slice of scores and outputs, columns 2 (l % 4) and
// 2 (l % 4) + 1: the m16n8 accumulator layout. Row max and row sum reduce
// over the 4 lanes that share a row. A policy (Bf16Op, Tf32Op) supplies
// the tile sizes, the row pitches, where Q lives, and the two products
// S = Q K^T and O += P V on its fragments; each loads a k-step's K or V
// fragments before the products that use them.
//
// bf16 (Bf16Op): Q's fragments in registers; mma.sync.m16n8k16 (bf16 in,
// f32 accumulate) on ldmatrix fragments of 64-row tiles, two stages; P*V
// on ldmatrix.trans fragments of V, with P entering as two bf16 terms, hi
// = bf16(p) and lo = bf16(p - hi), so about 16 bits of the f32
// probabilities survive (the TPU kernel multiplies P*V in f32). Rows are
// padded by 16 bytes, so the 8 row addresses of every ldmatrix fall in 8
// different bank groups. What
// bounds it: at [8,544,28,128] causal the bytes bound is 0.021 ms and the
// tensor-core bound 0.017 ms (counting only allowed pairs); the kernel
// does ~1.9x those operations (whole diagonal tiles, two P*V products)
// through mma.sync, at a fraction of the rate wgmma reaches. mma.sync
// rather than wgmma: its fragments are plain register layouts that
// ldmatrix fills from a padded tile, where wgmma wants its B tiles in a
// swizzled layout named by shared-memory descriptors.
//
// f32 (Tf32Op): split TF32 (3xTF32) mma.sync.m16n8k8 on 32-row f32 tiles,
// two stages. One TF32 product keeps ~11 significant bits, which breaks
// the f32 tolerance (1e-4); so every operand x is split once as hi =
// tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), and each
// product is lo*hi + hi*lo, then hi*hi, into the f32 accumulator (lo*lo,
// ~2^-22 of the product, is dropped). Each warp stages its 16 rows of Q
// in shared memory once (in registers a 128-wide head takes 64 a lane,
// and the kernel spilled) and splits them at each k-step, K and V as
// their fragments leave shared memory, P in registers after the
// exponent. ldmatrix is b16-only, so the B fragments are 8-byte
// shared loads: a k-step of Q K^T takes head dims in the order (0, 2, 4,
// 6, 1, 3, 5, 7) so each lane's two K values are adjacent (K rows pitched
// HD + 8 floats: the 16 lanes of a half-warp hit 32 banks); a k-step of
// P V takes its 8 keys in the same order, which is the accumulator layout
// of S (P needs no shuffle), and an output slice pair (2e, 2e + 1) takes
// dims 16 e + 2 n and 16 e + 2 n + 1, so each lane's two V values are
// adjacent (V rows pitched HD + 4 floats) and each lane stores 4
// contiguous output dims. What bounds it: operations, three TF32 products
// a pair at 495 TFLOP/s (0.103 ms at [8,544,28,128] causal; 0.254 ms at
// the CUDA cores' 67 TFLOP/s of plain f32).
//
// Head dim 256 (Gemma3): a warp's accumulator over all 256 output columns
// would be 128 registers a lane before Q, the scores and the V fragments,
// past the 255 a thread has. So a block has 8 warps: the two warps of a
// row group both compute the group's full scores and softmax (the same
// instructions on the same tile, so the same values) and each multiplies
// P by its half of V's columns, into 64 accumulator registers. The
// duplicated Q K^T costs a third more tensor work in bf16 and half more in
// f32; the alternative, P staged in shared memory between the two, costs
// a barrier a tile. Q lives in shared memory in both policies (bf16 reads
// its A fragments by ldmatrix). The ring and Q take 165 KB in bf16 and
// 197 KB in f32: one block an SM.
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

// Warps that share one 16-row group of the q tile, each owning 1 /
// col_split of the output columns: 2 at head dim 256, where one warp's
// f32 accumulator of 16 rows x 256 columns would take 128 registers a
// lane before Q, the scores and the V fragments, and 1 below it.
template <int HD>
__host__ __device__ constexpr int col_split() { return HD > 128 ? 2 : 1; }

// Threads of a block of prefill::attend<T, HD>: 4 row groups of 16 query
// rows, each served by col_split<HD>() warps.
template <int HD>
__host__ __device__ constexpr int threads() { return 128 * col_split<HD>(); }

// --------------------------------------------------------------- bf16
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

template <int HD>
struct Bf16Op {
  using T = __nv_bfloat16;
  static constexpr int kBK = 64;        // KV rows per ring stage
  static constexpr int kStages = 2;
  static constexpr int kPK = HD + 8;    // shared row pitches, elements
  static constexpr int kPV = HD + 8;
  static constexpr int kOut = HD / col_split<HD>();  // output columns a warp
  // Q's A fragments stay in registers up to hd 128 (64 a lane there); at
  // hd 256 Q is staged in shared memory and each k-step's fragment is
  // read by ldmatrix (the same values, so the same products)
  static constexpr bool kQRegs = HD <= 128;
  static constexpr int kPQ = kQRegs ? 0 : HD + 8;

  uint32_t qf[kQRegs ? HD / 16 : 1][4];  // Q's A fragments, k-steps of 16
  const T* qw;                           // or this row group's Q rows

  __device__ __forceinline__ void load_q(const T* q, long long o0,
                                         long long o1, bool v0, bool v1,
                                         int tg, const T* qs) {
    if constexpr (kQRegs) {
      const bool qal = (reinterpret_cast<uintptr_t>(q) & 3) == 0;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int c = 16 * ks + 2 * tg;
        qf[ks][0] = v0 ? load_pair(q + o0 + c, qal) : 0u;
        qf[ks][1] = v1 ? load_pair(q + o1 + c, qal) : 0u;
        qf[ks][2] = v0 ? load_pair(q + o0 + c + 8, qal) : 0u;
        qf[ks][3] = v1 ? load_pair(q + o1 + c + 8, qal) : 0u;
      }
    } else {
      qw = qs;
    }
  }

  static __device__ __forceinline__ void tile_scores(
      float (&s)[kBK / 8][4], const uint32_t (&a)[4],
      const uint32_t (&kf)[kBK / 16][4]) {
#pragma unroll
    for (int np = 0; np < kBK / 16; ++np) {
      mma_bf16(s[2 * np], a, kf[np][0], kf[np][1]);
      mma_bf16(s[2 * np + 1], a, kf[np][2], kf[np][3]);
    }
  }

  // s += Q K^T over the tile's kBK columns
  __device__ __forceinline__ void scores(float (&s)[kBK / 8][4], const T* Ks,
                                         int lane) const {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t kf[kBK / 16][4];
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np)
        ldmatrix_x4(kf[np], Ks + (16 * np + (lane >> 4) * 8 + (lane & 7)) *
                                     kPK + 16 * ks + ((lane >> 3) & 1) * 8);
      if constexpr (kQRegs) {
        tile_scores(s, qf[ks], kf);
      } else {
        // lanes 0-15 address rows 0-15 at k 16 ks, lanes 16-31 the same
        // rows at k 16 ks + 8: the m16k16 A fragment
        uint32_t a[4];
        ldmatrix_x4(a, qw + (lane & 15) * kPQ + 16 * ks + (lane >> 4) * 8);
        tile_scores(s, a, kf);
      }
    }
  }

  // acc += P V over this warp's kOut output columns (Vs points at the
  // first), P as hi + lo
  __device__ __forceinline__ void pv(float (&acc)[kOut / 8][4],
                                     const float (&s)[kBK / 8][4],
                                     const T* Vs, int lane) const {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      uint32_t vf[kOut / 16][4];
#pragma unroll
      for (int dp = 0; dp < kOut / 16; ++dp)
        ldmatrix_x4_trans(vf[dp], Vs + (16 * kk + ((lane >> 3) & 1) * 8 +
                                        (lane & 7)) * kPV +
                                      16 * dp + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < kOut / 16; ++dp) {
        mma_bf16(acc[2 * dp], ph, vf[dp][0], vf[dp][1]);
        mma_bf16(acc[2 * dp], pl, vf[dp][0], vf[dp][1]);
        mma_bf16(acc[2 * dp + 1], ph, vf[dp][2], vf[dp][3]);
        mma_bf16(acc[2 * dp + 1], pl, vf[dp][2], vf[dp][3]);
      }
    }
  }

  __device__ __forceinline__ void store(T* out, long long o0, long long o1,
                                        const float (&acc)[kOut / 8][4],
                                        float d0, float d1, bool v0, bool v1,
                                        int tg) const {
    const bool oal = (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll
    for (int d = 0; d < kOut / 8; ++d) {
      const int c = 8 * d + 2 * tg;
      if (v0) store_pair(out + o0 + c, acc[d][0] / d0, acc[d][1] / d0, oal);
      if (v1) store_pair(out + o1 + c, acc[d][2] / d1, acc[d][3] / d1, oal);
    }
  }
};

// ---------------------------------------------------------------- f32
// x as hi + lo, both TF32 (10 stored mantissa bits), each rounded to
// nearest with ties away from zero: the bits plus half a TF32 ulp
// (0x1000), masked with 0xffffe000, which is what cvt.rna.tf32.f32 gives
// for finite x in two integer instructions (cvt.rna adds NaN and infinity
// checks: ~5 instructions on sm_90a). x - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d += a * b: one m16n8k8 tile, TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in split TF32: the cross terms lo*hi and hi*lo first, then
// hi*hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int HD>
struct Tf32Op {
  using T = float;
  static constexpr int kBK = 32;        // KV rows per ring stage
  static constexpr int kStages = 2;
  static constexpr int kPK = HD + 8;    // = 8 (mod 32) words: 8-byte K reads
  static constexpr int kPV = HD + 4;    // = 4 (mod 16) words: 8-byte V reads
  static constexpr int kPQ = HD + 8;    // Q in shared memory, pitched as K
  static constexpr int kOut = HD / col_split<HD>();  // output columns a warp

  const float* qw;                      // this warp's 16 rows of Q

  __device__ __forceinline__ void load_q(const T*, long long, long long,
                                         bool, bool, int, const T* qs) {
    qw = qs;
  }

  // s += Q K^T over the tile's kBK columns. k-step ks takes head dims
  // 8 ks + 2 (l % 4) (A and B column l % 4) and + 1 (column l % 4 + 4)
  __device__ __forceinline__ void scores(float (&s)[kBK / 8][4], const T* Ks,
                                         int lane) const {
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      const float2 a = *reinterpret_cast<const float2*>(
          qw + g * kPQ + 8 * ks + 2 * tg);
      const float2 b = *reinterpret_cast<const float2*>(
          qw + (g + 8) * kPQ + 8 * ks + 2 * tg);
      uint32_t ah[4], al[4];
      split_tf32(a.x, ah[0], al[0]);    // row r0, column l % 4
      split_tf32(b.x, ah[1], al[1]);    // row r1
      split_tf32(a.y, ah[2], al[2]);    // row r0, column l % 4 + 4
      split_tf32(b.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        // column g of slice j: key 8 j + g
        const float2 k = *reinterpret_cast<const float2*>(
            Ks + (8 * j + g) * kPK + 8 * ks + 2 * tg);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(k.x, bh0, bl0);
        split_tf32(k.y, bh1, bl1);
        mma_3xtf32(s[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }

  // acc += P V over this warp's kOut output columns (Vs points at the
  // first). k-step kk is score slice kk, keys in the order (0, 2, 4,
  // 6, 1, 3, 5, 7): column l % 4 of P's A fragment is key 2 (l % 4), held
  // in s[kk][0] / [2], and column l % 4 + 4 is key 2 (l % 4) + 1, in
  // s[kk][1] / [3]. Output slices 2 e and 2 e + 1 take dims 16 e + 2 n and
  // 16 e + 2 n + 1 for their column n.
  __device__ __forceinline__ void pv(float (&acc)[kOut / 8][4],
                                     const float (&s)[kBK / 8][4],
                                     const T* Vs, int lane) const {
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      uint32_t ph[4], pl[4];
      split_tf32(s[kk][0], ph[0], pl[0]);
      split_tf32(s[kk][2], ph[1], pl[1]);
      split_tf32(s[kk][1], ph[2], pl[2]);
      split_tf32(s[kk][3], ph[3], pl[3]);
      const T* const va = Vs + (8 * kk + 2 * tg) * kPV + 2 * g;   // key 2 tg
      const T* const vb = va + kPV;                               // + 1
      float2 fa[kOut / 16], fb[kOut / 16];
#pragma unroll
      for (int e = 0; e < kOut / 16; ++e) {
        fa[e] = *reinterpret_cast<const float2*>(va + 16 * e);
        fb[e] = *reinterpret_cast<const float2*>(vb + 16 * e);
      }
#pragma unroll
      for (int e = 0; e < kOut / 16; ++e) {
        const float2 a = fa[e], b = fb[e];
        uint32_t ah, al, bh, bl;
        split_tf32(a.x, ah, al);
        split_tf32(b.x, bh, bl);
        mma_3xtf32(acc[2 * e], ph, pl, ah, bh, al, bl);
        split_tf32(a.y, ah, al);
        split_tf32(b.y, bh, bl);
        mma_3xtf32(acc[2 * e + 1], ph, pl, ah, bh, al, bl);
      }
    }
  }

  // rows r0 and r1, dims 16 e + 4 (l % 4) .. + 3 of each slice pair, as
  // 16-byte stores (out is the wrappers' torch.empty_like: aligned)
  __device__ __forceinline__ void store(T* out, long long o0, long long o1,
                                        const float (&acc)[kOut / 8][4],
                                        float d0, float d1, bool v0, bool v1,
                                        int tg) const {
#pragma unroll
    for (int e = 0; e < kOut / 16; ++e) {
      const float(&x)[4] = acc[2 * e];
      const float(&y)[4] = acc[2 * e + 1];
      const int c = 16 * e + 4 * tg;
      if (v0)
        *reinterpret_cast<float4*>(out + o0 + c) =
            make_float4(x[0] / d0, y[0] / d0, x[1] / d0, y[1] / d0);
      if (v1)
        *reinterpret_cast<float4*>(out + o1 + c) =
            make_float4(x[2] / d1, y[2] / d1, x[3] / d1, y[3] / d1);
    }
  }
};

// The product policy of element type T.
template <typename T, int HD>
using OpOf = typename std::conditional<std::is_same<T, __nv_bfloat16>::value,
                                       Bf16Op<HD>, Tf32Op<HD>>::type;

// Dynamic shared memory a launch of prefill::attend<T, HD> needs: the
// ring, kStages x (K, V) tiles of kBK padded rows.
template <typename T, int HD>
constexpr int smem_bytes() {
  using Op = OpOf<T, HD>;
  return (Op::kStages * Op::kBK * (Op::kPK + Op::kPV) + kBQ * Op::kPQ) *
         (int)sizeof(T);
}

// ----------------------------------------------------------- skeleton
// q and out are [B, Sq, H, HD]; q_pos is [B, Sq] (null: row i sits at
// position i). (tile, h, b) name this block's q tile, query head and batch
// row; rows addresses batch row b at KV head h / (H / KV). vec: every row
// the Rows hand out is 16-byte aligned, so tiles are staged in 16-byte
// words by cp.async (else element by element; the staged values are the
// same).
template <typename Op, int HD, typename Rows, typename T = typename Op::T>
__device__ __forceinline__ void attend_tc(const T* __restrict__ q,
                                          T* __restrict__ out,
                                          const int* __restrict__ q_pos,
                                          int tile, int h, int b, int Sq,
                                          int H, int window, bool causal,
                                          float scale, bool vec,
                                          const Rows& rows) {
  constexpr int BK = Op::kBK, S = Op::kStages, PK = Op::kPK, PV = Op::kPV;
  constexpr int kSplit = col_split<HD>(), kThreads = threads<HD>();
  constexpr int ND = Op::kOut / 8;       // 8-column slices of a warp's output
  constexpr int NS = BK / 8;             // 8-column slices of a score tile
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kWords = HD / kVec;      // 16-byte words a row
  constexpr int kStage = BK * (PK + PV); // elements a ring stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // [stage][K | V]
  __shared__ int s_qmin, s_qmax;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp w serves row group w % 4 and output columns part w / 4
  const int rw = warp % 4, part = warp / 4;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = tile * kBQ + rw * 16 + g, r1 = r0 + 8;
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
  const int cq = part * Op::kOut;         // this warp's first output column
  // Op::kPQ > 0: Q in shared memory after the ring, row group w's 16 rows
  // at qs
  T* const qs = ring + S * kStage + rw * 16 * Op::kPQ;
  if constexpr (Op::kPQ > 0) {
    // the warps of row group w stage its 16 rows (zeros past Sq); the
    // barrier before the KV loop orders these writes before any read
    if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
      for (int idx = lane + 32 * part; idx < 16 * kWords;
           idx += 32 * kSplit) {
        const int i = idx / kWords, d = kVec * (idx % kWords);
        const int r = tile * kBQ + rw * 16 + i;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (r < Sq)
          x = *reinterpret_cast<const uint4*>(q + ((qb + r) * H + h) * HD + d);
        *reinterpret_cast<uint4*>(qs + i * Op::kPQ + d) = x;
      }
    } else {
      for (int idx = lane + 32 * part; idx < 16 * HD; idx += 32 * kSplit) {
        const int i = idx / HD, d = idx % HD, r = tile * kBQ + rw * 16 + i;
        qs[i * Op::kPQ + d] =
            r < Sq ? q[((qb + r) * H + h) * HD + d] : from_f32<T>(0.f);
      }
    }
    __syncwarp();
  }
  Op op;
  op.load_q(q, o0, o1, v0, v1, tg, qs);
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: this lane's
  __syncthreads();

  const long long lo = (long long)s_qmin - window + 1;
  const int c_lo = lo > 0 ? (int)lo : 0;
  const int c_hi = causal ? min(klen, s_qmax + 1) : klen;   // exclusive
  const int t0 = c_lo / BK;
  const int nt = c_hi > t0 * BK ? (c_hi - t0 * BK + BK - 1) / BK : 0;

  // stage tile t into ring slot s, as one cp.async group
  auto stage = [&](int t, int s) {
    T* const Ks = ring + s * kStage;
    T* const Vs = Ks + BK * PK;
    const int c0 = t * BK;
    if (vec) {
      static_assert(BK * kWords % kThreads == 0, "whole words a thread");
#pragma unroll
      for (int it = 0; it < BK * kWords / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        const int j = idx / kWords, w = idx % kWords;
        const T* kr;
        const T* vr;
        const bool have = rows.row(c0 + j, kr, vr);
        cp_async16(Ks + j * PK + kVec * w, have ? kr + kVec * w : q, have);
        cp_async16(Vs + j * PV + kVec * w, have ? vr + kVec * w : q, have);
      }
    } else {
      const T zero = from_f32<T>(0.f);
      for (int idx = tid; idx < BK * HD; idx += kThreads) {
        const int j = idx / HD, d = idx % HD;
        const T* kr;
        const T* vr;
        const bool have = rows.row(c0 + j, kr, vr);
        Ks[j * PK + d] = have ? kr[d] : zero;
        Vs[j * PV + d] = have ? vr[d] : zero;
      }
    }
    cp_async_commit();
  };

  // tiles t0 .. t0 + S - 2 in flight before the loop; an empty group
  // stands in for a tile past the end, so group i is always tile t0 + i
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nt) stage(t0 + i, i);
    else cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    if (i + S - 1 < nt) stage(t0 + i + S - 1, (unsigned)(i + S - 1) % S);
    else cp_async_commit();
    cp_async_wait<S - 1>();             // tile t0 + i has landed
    __syncthreads();
    const T* const Ks = ring + ((unsigned)i % S) * kStage;
    const T* const Vs = Ks + BK * PK;
    const int c0 = (t0 + i) * BK;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    op.scores(s, Ks, lane);

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

    op.pv(acc, s, Vs + cq, lane);
    __syncthreads();                    // slot i % S is refilled next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  op.store(out, o0 + cq, o1 + cq, acc, fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f),
           v0, v1, tg);
}

// The tile function of both prefill kernels. A launch passes
// smem_bytes<T, HD>() of dynamic shared memory.
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       T* __restrict__ out,
                                       const int* __restrict__ q_pos,
                                       int tile, int h, int b, int Sq, int H,
                                       int window, bool causal, float scale,
                                       bool vec, const Rows& rows) {
  attend_tc<OpOf<T, HD>, HD>(q, out, q_pos, tile, h, b, Sq, H, window, causal,
                             scale, vec, rows);
}

}  // namespace prefill
