// Fused diff restore for Hopper: Algorithm 1 of the paper (§4.4) — pick
// the Mirror's diff block or the Master's, recover RoPE positions on K,
// write the block into its page of the paged KV pool.
//
// Replaces: src/repro/kernels/diff_restore.py fused_diff_restore_kernel
// (one mirror per launch, grid (L, nb)) and fused_family_restore_kernel
// (a whole Master family per launch, grid (L, nb, M) with the mirror
// innermost so the Master block stays resident in VMEM). Both Pallas
// kernels share one body (_kernel / _family_kernel); so do these.
//
// What bounds it: bytes. A block is read once (Master or diff) and
// written once per mirror; the only arithmetic is the rotation of
// shifted K frames (one sincosf per element pair), none at all for
// aligned frames.
//
// Design: one thread block per (Master block b, layer l, KV head kv).
// The tile of one KV head is [bt, hd] — 32 x 128 at Qwen2.5-7B, 8 KB per
// plane in bf16 — and it lives in REGISTERS across the block's threads:
// thread (t, c) holds token t's 16-byte chunk c of the first half of the
// head dim and the matching chunk of the second half (the two halves of
// a RoPE pair), for K and V — four 16-byte words, 16 registers. Splitting
// the 64 KB (l, b) tile over KV heads keeps it out of shared memory (no
// 48 KB static limit, no barrier) and gives L * nb * KV blocks (3696 at
// Qwen2.5-7B's 28 x 33 x 4) for 132 SMs.
//
// Any block size and head dim (hd % 16 == 0): a tile of more than 1024
// (token, chunk) pairs — f32 at bt 64 and hd 256 (Gemma3's recovery at
// block 64), bt 128 at hd 128, bf16 at bt 128 and hd 256: 2048 — is cut
// over a third grid axis into parts of 1024 pairs: part z takes pairs
// z * 1024 .. z * 1024 + 1023 of the tile (pair t * chunks + c), and a
// tile of at most 1024 pairs is one part of one thread a pair.
//
// The family kernel loads the Master tile once and then loops over the M
// mirrors INSIDE the block: mirror m takes its diff tile where
// diff_slot[m, b] >= 0 (a fresh load), else the Master tile already in
// registers, rotates K by delta_pos[m, b, t] and stores to page
// slot_map[m, b]. Each Master block crosses HBM once per (layer, block,
// head) and is written M times. The per-mirror kernel is the same body
// with M = 1.
//
// Numbers: a zero delta stores the loaded words untouched (no float
// round trip), so aligned frames are pure data movement and bit-exact
// with the plain version. A nonzero delta rotates in f32 with the
// wrapper's f32 1/theta^(i/half) table and the accurate sincosf (no
// --use_fast_math), then rounds to nearest even, as rope_align.cu does.
// All index maps were checked on the host by the wrapper (pages < P,
// disjoint), so no store here can leave the pool.
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

__device__ __forceinline__ void set_word(uint4& w, int i, unsigned u) {
  if (i == 0) w.x = u;
  else if (i == 1) w.y = u;
  else if (i == 2) w.z = u;
  else w.w = u;
}

// Element j of a 16-byte word as f32, and back (round to nearest even).
template <typename T> struct Lanes;

template <> struct Lanes<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ float get(const uint4& w, int j) {
    return __uint_as_float(word_of(w, j));
  }
  static __device__ __forceinline__ void put(uint4& w, int j, float x) {
    set_word(w, j, __float_as_uint(x));
  }
};

template <> struct Lanes<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ float get(const uint4& w, int j) {
    const unsigned u = word_of(w, j >> 1);
    return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  static __device__ __forceinline__ void put(uint4& w, int j, float x) {
    const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    const unsigned u = word_of(w, j >> 1);
    set_word(w, j >> 1,
             (j & 1) ? ((u & 0x0000ffffu) | (b << 16)) : ((u & 0xffff0000u) | b));
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4& w) {
  *reinterpret_cast<uint4*>(p) = w;
}

// Rotate the pairs (lo[j], hi[j]) — head-dim indices i0 + j and
// i0 + j + hd/2 — by the position delta d.
template <typename T>
__device__ __forceinline__ void rotate(uint4& lo, uint4& hi, int d,
                                       const float* __restrict__ inv_freq,
                                       int i0) {
#pragma unroll
  for (int j = 0; j < Lanes<T>::kN; ++j) {
    float sn, cs;
    sincosf((float)d * inv_freq[i0 + j], &sn, &cs);
    const float x1 = Lanes<T>::get(lo, j);
    const float x2 = Lanes<T>::get(hi, j);
    Lanes<T>::put(lo, j, x1 * cs - x2 * sn);
    Lanes<T>::put(hi, j, x2 * cs + x1 * sn);
  }
}

// The shared body. Grid (nb * KV, L, parts); pair p = blockIdx.z *
// blockDim.x + threadIdx.x of the tile's bt * (hd/2) / kN.
// master [L, nb, bt, KV, hd]; diff [M, L, ndb, bt, KV, hd];
// diff_slot / slot_map [M, nb]; delta_pos [M, nb, bt]; pools [L, P, bt,
// KV, hd].
template <typename T>
__global__ void __launch_bounds__(1024)
restore_kernel(const T* __restrict__ mk, const T* __restrict__ mv,
               const T* __restrict__ dk, const T* __restrict__ dv,
               const int* __restrict__ diff_slot,
               const int* __restrict__ slot_map,
               const int* __restrict__ delta_pos,
               const float* __restrict__ inv_freq, T* __restrict__ pk,
               T* __restrict__ pv, int M, int L, int nb, int ndb, int bt,
               int KV, int hd, int P) {
  constexpr int kN = Lanes<T>::kN;
  const int half = hd / 2;
  const int chunks = half / kN;
  const int b = blockIdx.x / KV, kv = blockIdx.x % KV, l = blockIdx.y;
  const int p = blockIdx.z * blockDim.x + threadIdx.x;
  if (p >= bt * chunks) return;   // the last part's spare threads
  const int t = p / chunks, c = p % chunks;
  const long long tile = (long long)bt * KV * hd;       // one (l, b) block
  const long long in_tile = ((long long)t * KV + kv) * hd + c * kN;

  const long long mo = ((long long)l * nb + b) * tile + in_tile;
  const uint4 mk_lo = load16(mk + mo), mk_hi = load16(mk + mo + half);
  const uint4 mv_lo = load16(mv + mo), mv_hi = load16(mv + mo + half);

  for (int m = 0; m < M; ++m) {
    const int mb = m * nb + b;
    const int row = diff_slot[mb];
    uint4 k_lo = mk_lo, k_hi = mk_hi, v_lo = mv_lo, v_hi = mv_hi;
    if (row >= 0) {
      const long long o = (((long long)m * L + l) * ndb + row) * tile + in_tile;
      k_lo = load16(dk + o);
      k_hi = load16(dk + o + half);
      v_lo = load16(dv + o);
      v_hi = load16(dv + o + half);
    }
    const int d = delta_pos[(long long)mb * bt + t];
    if (d != 0) rotate<T>(k_lo, k_hi, d, inv_freq, c * kN);
    const long long po = ((long long)l * P + slot_map[mb]) * tile + in_tile;
    store16(pk + po, k_lo);
    store16(pk + po + half, k_hi);
    store16(pv + po, v_lo);
    store16(pv + po + half, v_hi);
  }
}

int launch(const void* mk, const void* mv, const void* dk, const void* dv,
           const int* diff_slot, const int* slot_map, const int* delta_pos,
           const float* inv_freq, void* pk, void* pv, int M, int L, int nb,
           int ndb, int bt, int KV, int hd, int P, int dtype, void* stream) {
  if (M == 0 || L == 0 || nb == 0) return 0;
  if (bt < 1 || hd < 16 || hd % 16 != 0) return (int)cudaErrorInvalidValue;
  // (token, 16-byte chunk) pairs of one tile, in parts of at most 1024
  const long long pairs =
      (long long)bt * (hd / 2) /
      (dtype == kF32 ? Lanes<float>::kN : Lanes<__nv_bfloat16>::kN);
  const int threads = (int)(pairs < 1024 ? pairs : 1024);
  const long long parts = (pairs + threads - 1) / threads;
  if (parts > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(nb * KV), (unsigned)L, (unsigned)parts);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    restore_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)mk, (const float*)mv, (const float*)dk, (const float*)dv,
        diff_slot, slot_map, delta_pos, inv_freq, (float*)pk, (float*)pv, M, L,
        nb, ndb, bt, KV, hd, P);
  } else {
    restore_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)mk, (const __nv_bfloat16*)mv,
        (const __nv_bfloat16*)dk, (const __nv_bfloat16*)dv, diff_slot,
        slot_map, delta_pos, inv_freq, (__nv_bfloat16*)pk, (__nv_bfloat16*)pv,
        M, L, nb, ndb, bt, KV, hd, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One mirror: diff [L, ndb, bt, KV, hd], maps [nb], delta_pos [nb, bt].
extern "C" int fused_diff_restore_launch(
    const void* mk, const void* mv, const void* dk, const void* dv,
    const int* diff_slot, const int* slot_map, const int* delta_pos,
    const float* inv_freq, void* pk, void* pv, int L, int nb, int ndb, int bt,
    int KV, int hd, int P, int dtype, void* stream) {
  return launch(mk, mv, dk, dv, diff_slot, slot_map, delta_pos, inv_freq, pk,
                pv, 1, L, nb, ndb, bt, KV, hd, P, dtype, stream);
}

// A whole family: diff [M, L, ndb, bt, KV, hd], maps [M, nb], delta_pos
// [M, nb, bt] — ONE launch, the mirror loop inside each block.
extern "C" int fused_family_restore_launch(
    const void* mk, const void* mv, const void* dk, const void* dv,
    const int* diff_slot, const int* slot_map, const int* delta_pos,
    const float* inv_freq, void* pk, void* pv, int M, int L, int nb, int ndb,
    int bt, int KV, int hd, int P, int dtype, void* stream) {
  return launch(mk, mv, dk, dv, diff_slot, slot_map, delta_pos, inv_freq, pk,
                pv, M, L, nb, ndb, bt, KV, hd, P, dtype, stream);
}
