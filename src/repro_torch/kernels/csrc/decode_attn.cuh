// Single-query decode attention over 32-row KV tiles, shared by the dense
// (flash_decode.cu) and the paged (flash_decode_paged.cu) decode kernels.
//
// What bounds it: bytes. At G query heads per KV head the arithmetic is
// 2 G flops per loaded K/V element (G = 7: ~7 flop/byte in bf16), far
// below the ~295 at which Hopper's tensor cores would be the limit, so it
// stays on the CUDA cores in f32 for both element types and the design is
// about bytes in flight.
//
// Split-KV (flash-decoding). The grid is (KV head, sequence, split). A
// (KV head, sequence) pair visits tiles [t_begin, t_end); split s walks
// tiles t_begin + s*kSplitTiles .. t_begin + (s+1)*kSplitTiles - 1, so a
// tile's split depends on the tile index alone, never on the grid or the
// batch. Splits past a sequence's own tile count return at once (lengths
// stay on the device). Every tile in [t_begin, t_end) holds an allowed
// column, so every split's running max is a real score and the combine's
// weights e^(m_i - M) zero any column masked to -2^30.
//
// Inside a block (256 threads, the G <= 8 query heads of one KV head):
// the split's tiles are copied in their own type into a ring of one
// shared-memory stage per tile by 16-byte cp.async copies (a row past the
// storage is zero-filled by the src-size-0 form), all issued before the
// first is waited for. Rows are padded by 16 bytes, so the 16-byte reads of 8
// lanes (one per key) fall in 8 different bank groups and every copy's
// destination stays 16-byte aligned. q is held in shared memory as f32.
// Per tile: warp g scores head g, one key per lane, folds the scores
// into the head's running (max, sum) with shuffles (the recurrence of
// _softmax_update, src/repro/kernels/flash_prefill.py:46-66, in f32) and
// publishes p and the rescale factor; then each thread accumulates one
// output column of every head in registers over its share of the rows.
// Two barriers a tile. At these sizes a call is a chain of round trips
// and short serial loops, not a stream of bytes: one warp per head (256
// threads, not 128) halves each warp's serial work a tile, and took the
// paged call at Qwen2.5-7B's shape from 0.028 to 0.024 ms on an H100.
//
// Combine. Every split writes its f32 partial (acc G x HD, then m and l
// per head) to scratch, fences, and takes an integer ticket; the last to
// arrive resets the ticket to 0 and merges the splits in split order,
// M = max m_i, l = sum e^(m_i - M) l_i, o = sum e^(m_i - M) acc_i /
// max(l, 1e-30). No floating-point atomics: two calls give the same bits.
// A pair with one split goes the same way (its weight is e^0 = 1), and a
// pair with no tile has one empty split (acc 0, l 0), so it writes zeros.
// The merge keeps its loads in flight together (each split's m and l in
// one round trip, a chunk of splits' acc at once): a merge that waited on
// each load in turn was ~15 us of a ~37 us call.
//
// The two kernels differ only in where tile t's row j lives and which of
// its columns are allowed: a Rows type supplies both,
//
//   bool row(int t, int j, const T*& k, const T*& v) const;
//       // point k/v at the row's hd values of this KV head (16-byte
//       // aligned); false for a row past the storage (staged as zeros)
//   bool valid(int t, int j) const;   // the column is allowed
//
// so the arithmetic on a tile, the splits and the combine are one piece
// of code: the dense and paged kernels compute the same bits whenever
// their tiles hold the same rows under the same masks (the port's paged
// == dense contract on the card).
#pragma once

#include "common.cuh"

namespace decode {

constexpr int kBT = 32;          // KV rows per tile == warp width == page rows
constexpr int kMaxG = 8;         // query heads per KV head
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// tiles per split, each with its own ring stage, so all of a split's K/V
// is in flight at once. The build passes ops.DECODE_SPLIT_TILES, which
// also sizes the wrappers' scratch.
#ifndef DECODE_SPLIT_TILES
#error "DECODE_SPLIT_TILES is set by repro_torch.kernels.build"
#endif
constexpr int kSplitTiles = DECODE_SPLIT_TILES;

// Elements of one padded shared-memory row of T.
template <typename T, int HD>
__host__ __device__ constexpr int row_elems() {
  return HD + 16 / (int)sizeof(T);
}

// Dynamic shared memory of decode::attend<T, HD>: the ring.
template <typename T, int HD>
__host__ __device__ constexpr int smem_bytes() {
  return kSplitTiles * 2 * kBT * row_elems<T, HD>() * (int)sizeof(T);
}

// Splits of a pair of ntiles tiles: one, empty, for none.
__host__ __device__ constexpr int n_splits(int ntiles) {
  return ntiles > 0 ? (ntiles + kSplitTiles - 1) / kSplitTiles : 1;
}

// q and out are [B, H, HD]; b and kvh name this block's sequence and KV
// head, blockIdx.z its split. Tiles [t_begin, t_end) are visited; an
// empty range writes zeros. part is the scratch of gridDim.z partials of
// G * (HD + 2) floats per pair; tickets[b * KV + kvh] is 0 at launch and
// left 0.
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       T* __restrict__ out, int b, int kvh,
                                       int H, int KV, float scale,
                                       int t_begin, int t_end,
                                       const Rows& rows,
                                       float* __restrict__ part,
                                       int* __restrict__ tickets) {
  constexpr int kVec = 16 / (int)sizeof(T);   // elements per 16-byte word
  constexpr int kWords = HD / kVec;           // words per row
  constexpr int kRow = row_elems<T, HD>();
  constexpr int kGroups = kThreads / HD;      // row groups of the P.V step
  constexpr int kGroupRows = kBT / kGroups;
  constexpr int kCopies = (kBT * kWords + kThreads - 1) / kThreads;
  constexpr int kOuts = kMaxG * HD / kThreads;  // outputs a thread merges
  static_assert(kThreads % HD == 0 && kOuts >= 1,
                "HD must be 32, 64, 128 or 256");
  static_assert(kMaxG <= kWarps, "warp g scores head g");
  static_assert(kGroups * kMaxG * HD * 4 <= smem_bytes<T, HD>(),
                "the row groups' sums reuse the ring");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kSplitTiles][K, V][kBT][kRow]
  __shared__ __align__(16) float qs[kMaxG][HD];
  __shared__ __align__(16) float ps[kBT][kMaxG];
  __shared__ float a_s[kMaxG], m_s[kMaxG], l_s[kMaxG];
  __shared__ float lw[kBT][kMaxG];             // the merge's e^(m_i - M) l_i
  __shared__ int last_s;

  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.z;
  const int nsplit = n_splits(t_end - t_begin);
  if (s >= nsplit) return;
  const int t0 = t_begin + s * kSplitTiles;
  const int n = min(kSplitTiles, t_end - t0);  // <= 0 for an empty pair

  // tile t0 + i into ring stage i, one commit group per stage
  auto stage = [&](int i) {
    T* ks = ring + i * 2 * kBT * kRow;
    T* vs = ks + kBT * kRow;
    const int t = t0 + i;
#pragma unroll
    for (int c = 0; c < kCopies; ++c) {
      const int idx = c * kThreads + tid;
      if (idx >= kBT * kWords) break;
      const int j = idx / kWords, w = idx % kWords;
      const T* kr;
      const T* vr;
      const bool ok = rows.row(t, j, kr, vr);
      cp_async16(ks + j * kRow + w * kVec, ok ? kr + w * kVec : q, ok);
      cp_async16(vs + j * kRow + w * kVec, ok ? vr + w * kVec : q, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kSplitTiles; ++i) {
    if (i < n) stage(i);
    cp_async_commit();
  }
  const T* qb = q + ((long long)b * H + kvh * G) * HD;
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {    // unrolled: all loads in flight
    const int idx = r * kThreads + tid;
    if (idx < G * HD) qs[idx / HD][idx % HD] = to_f32(qb[idx]);
  }

  float m = kNegInf, l = 0.f;   // warp g's running max and sum of head g
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  const int col = tid % HD, grp = tid / HD;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kSplitTiles - 1>();      // stage i has landed
    __syncthreads();
    const T* ks = ring + i * 2 * kBT * kRow;
    const T* vs = ks + kBT * kRow;
    const int t = t0 + i;

    // warp g: the score of key `lane` for head g
    if (warp < G) {
      float dot = 0.f;
      const uint4* krow = reinterpret_cast<const uint4*>(ks + lane * kRow);
      const float* qg = qs[warp];
#pragma unroll 4
      for (int w = 0; w < kWords; ++w) {
        const uint4 kw = krow[w];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          dot += qg[w * kVec + e] * word_elem<T>(kw, e);
      }
      const float x = rows.valid(t, lane) ? dot * scale : kNegInf;
      const float m_new = fmaxf(m, warp_max(x));
      const float p = expf(x - m_new);
      const float sum = warp_sum(p);
      const float alpha = expf(m - m_new);
      l = alpha * l + sum;
      m = m_new;
      ps[lane][warp] = p;
      if (lane == 0) a_s[warp] = alpha;
    }
    __syncthreads();

    // column `col` of every head over rows grp * kGroupRows ..
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] *= a_s[g];
#pragma unroll 4
    for (int jj = 0; jj < kGroupRows; ++jj) {
      const int j = grp * kGroupRows + jj;
      const float v = to_f32(vs[j * kRow + col]);
      const float4 p0 = *reinterpret_cast<const float4*>(&ps[j][0]);
      const float4 p1 = *reinterpret_cast<const float4*>(&ps[j][4]);
      const float pj[kMaxG] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] += pj[g] * v;
    }
    cp_async_commit();     // an empty group: the next wait is for stage i + 1
  }

  // the row groups' sums (through the ring, now free) and (m, l)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [kGroups][kMaxG][HD]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) red[(grp * kMaxG + g) * HD + col] = acc[g];
  if (lane == 0 && warp < G) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();

  const long long pair = (long long)b * KV + kvh;
  const int W = G * (HD + 2);                  // floats of one partial
  float* base = part + pair * gridDim.z * W;
  float* mine = base + (long long)s * W;
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float a = red[g * HD + d];
#pragma unroll
    for (int r = 1; r < kGroups; ++r) a += red[(r * kMaxG + g) * HD + d];
    mine[idx] = a;
  }
  if (tid < G) {
    mine[G * HD + tid] = m_s[tid];
    mine[G * HD + G + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(&tickets[pair], 1) == nsplit - 1;
    if (last_s) tickets[pair] = 0;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // M per head: warp g takes head g, its lanes stride over the splits;
  // the first kBT splits' (m, l) come in the same loads and give their
  // weights e^(m_i - M) and e^(m_i - M) l_i at once
  float (*ws)[kMaxG] = ps;
  if (warp < G) {
    const int g = warp;
    float m0 = kNegInf, l0 = 0.f;
    if (lane < nsplit) {
      m0 = __ldcg(base + (long long)lane * W + G * HD + g);
      l0 = __ldcg(base + (long long)lane * W + G * HD + G + g);
    }
    float mx = m0;
    for (int i = lane + kBT; i < nsplit; i += kBT)
      mx = fmaxf(mx, __ldcg(base + (long long)i * W + G * HD + g));
    mx = warp_max(mx);
    if (lane == 0) m_s[g] = mx;
    const float w = expf(m0 - mx);
    ws[lane][g] = w;
    lw[lane][g] = w * l0;
  }
  // then every thread adds the splits to its outputs tid + r * kThreads
  // in split order, kBT splits at a time, their acc loads in flight
  // together (later chunks load their weights first)
  float lsum[kOuts], num[kOuts];
#pragma unroll
  for (int r = 0; r < kOuts; ++r) lsum[r] = num[r] = 0.f;
  for (int c = 0; c < nsplit; c += kBT) {
    if (c > 0) {
      __syncthreads();
      if (warp < G && c + lane < nsplit) {
        const float* pi = base + (long long)(c + lane) * W;
        const float w = expf(__ldcg(pi + G * HD + warp) - m_s[warp]);
        ws[lane][warp] = w;
        lw[lane][warp] = w * __ldcg(pi + G * HD + G + warp);
      }
    }
    __syncthreads();
    const int nc = min(kBT, nsplit - c);
#pragma unroll 4
    for (int i = 0; i < nc; ++i) {
      const float* pi = base + (long long)(c + i) * W;
#pragma unroll
      for (int r = 0; r < kOuts; ++r) {
        const int idx = r * kThreads + tid;
        if (idx < G * HD) {
          const int g = idx / HD;
          lsum[r] += lw[i][g];
          num[r] += ws[i][g] * __ldcg(pi + idx);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {
    const int idx = r * kThreads + tid;
    if (idx < G * HD)
      out[((long long)b * H + kvh * G) * HD + idx] =
          from_f32<T>(num[r] / fmaxf(lsum[r], 1e-30f));
  }
}

}  // namespace decode
