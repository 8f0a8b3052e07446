// Paged single-query decode attention for Hopper.
//
// Replaces: src/repro/kernels/flash_decode.py flash_decode_paged_kernel (the
// Pallas kernel whose BlockSpec index map resolves KV tile j to
// pool[page_idx[j]] through a scalar-prefetched page table, one grid row
// per query head).
//
// Function: for each sequence b, its one query per head attends over the
// pages page_idx[b, :] (column t*bt + j at position t*bt + j, valid iff
// < span_len[b]) and then over dense tail tiles (tail row r at position
// span_len[b] + r, valid iff r < tail_len). The query sits after every
// valid column, at qpos = span_len[b] + tail_len - 1, and a valid column
// at position c is allowed iff qpos - c < window (the TPU kernel's mask;
// the wrapper passes INT_MAX for its unbounded window 0). Lengths live on
// the device, one per sequence, so a decode step needs no host sync.
//
// What bounds it: bytes. Each valid page is read once per KV head and the
// arithmetic is two flops per loaded element per query head of the group.
//
// Design: the grid is (KV head, sequence, split): one block of 256 threads
// per split of decode::kSplitTiles pages of a (KV head, sequence) pair
// covers the G query heads that share that KV head (G = 7 for
// Qwen2.5-7B), so each page is read from device memory once per group,
// not once per query head, and the card has KV x B x S blocks (Qwen at 18
// pages: 288) instead of KV x B (32). The pair walks only the
// ceil(span_len / bt) pages the sequence needs, then the tail, one page
// (bt = 32 rows) per tile of decode::attend (decode_attn.cuh): a cp.async
// ring, the tile arithmetic and the fixed-order combine of the splits,
// which the dense decode kernel (flash_decode.cu) shares. As there, tiles
// wholly before the window are never loaded: the pair's first tile is the
// one that holds position qpos - window + 1, and splits count from it.
// Where the span is whole pages, tile t holds positions t*32 .. t*32+31
// in both kernels, so the first tile, the splits and the masks are the
// dense kernel's and the two compute the same bits, capped (softcap > 0,
// the kCap instance) or not.
#include "decode_attn.cuh"

using decode::kBT;
using decode::kMaxG;
using decode::kThreads;
using decode::n_splits;

namespace {

// Tile t < npages is page page_idx[b, t]; tile npages + u is rows
// u*32 .. u*32+31 of sequence b's dense tail.
template <typename T, int HD>
struct PagedRows {
  const T* pk;
  const T* pv;
  const int* pages;          // page_idx row of sequence b
  const T* tk;               // sequence b's tail, or null
  const T* tv;
  int KV, kvh, npages, Tp, span, tail_len, qpos, window;

  __device__ __forceinline__ bool row(int t, int j, const T*& k,
                                      const T*& v) const {
    long long o;
    if (t < npages) {
      o = (((long long)pages[t] * kBT + j) * KV + kvh) * HD;
      k = pk + o;
      v = pv + o;
      return true;
    }
    const int r = (t - npages) * kBT + j;
    if (r >= Tp) return false;
    o = ((long long)r * KV + kvh) * HD;
    k = tk + o;
    v = tv + o;
    return true;
  }
  __device__ __forceinline__ bool valid(int t, int j) const {
    if (t < npages) {
      const int c = t * kBT + j;
      return c < span && qpos - c < window;
    }
    const int r = (t - npages) * kBT + j;
    return r < tail_len && qpos - (span + r) < window;
  }
};

}  // namespace

template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                          const T* __restrict__ pv, const int* __restrict__ page_idx,
                          const int* __restrict__ span_len,
                          const T* __restrict__ tk, const T* __restrict__ tv,
                          T* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ tickets, int H, int KV, int nbt,
                          int Tp, int tail_len, int window, float scale,
                          float softcap) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int span = span_len[b];
  const int npages = min((span + kBT - 1) / kBT, nbt);
  const int ntail = tk ? (tail_len + kBT - 1) / kBT : 0;
  const int qpos = span + (tk ? tail_len : 0) - 1;
  const long long tail_off = (long long)b * Tp * KV * HD;
  const PagedRows<T, HD> rows{pk, pv, page_idx + (long long)b * nbt,
                              tk ? tk + tail_off : nullptr,
                              tv ? tv + tail_off : nullptr,
                              KV, kvh, npages, Tp, span, tail_len, qpos,
                              window};
  // the first tile with an allowed column: the page, or else the tail
  // tile, that holds position lo = qpos - window + 1 (window >= 1)
  const long long lo = max((long long)qpos - window + 1, 0LL);
  const int t_end = npages + ntail;
  const int t_begin = min(lo < span ? (int)(lo / kBT)
                                    : npages + (int)((lo - span) / kBT),
                          t_end);
  decode::attend<T, HD, kCap>(q, out, b, kvh, H, KV, scale, softcap, t_begin,
                              t_end, rows, part, tickets);
}

template <typename T, int HD, bool kCap>
static int launch_hd(dim3 grid, const T* q, const T* pk, const T* pv,
                     const int* page_idx, const int* span_len, const T* tk,
                     const T* tv, T* out, float* part, int* tickets, int H,
                     int KV, int nbt, int Tp, int tail_len, int window,
                     float scale, float softcap, cudaStream_t st) {
  constexpr int smem = decode::smem_bytes<T, HD>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_paged_kernel<T, HD, kCap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_decode_paged_kernel<T, HD, kCap><<<grid, kThreads, smem, st>>>(
      q, pk, pv, page_idx, span_len, tk, tv, out, part, tickets, H, KV, nbt,
      Tp, tail_len, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_typed(const void* q, const void* pk, const void* pv,
                        const int* page_idx, const int* span_len,
                        const void* tk, const void* tv, void* out,
                        float* part, int* tickets, int B, int H, int KV,
                        int hd, int nbt, int Tp, int tail_len, int S,
                        int window, float scale, float softcap,
                        cudaStream_t st) {
  dim3 grid(KV, B, S);
  const T* qq = (const T*)q;
  const T* kk = (const T*)pk;
  const T* vv = (const T*)pv;
  const T* tkk = (const T*)tk;
  const T* tvv = (const T*)tv;
  T* oo = (T*)out;
  switch (hd) {
#define PAGED_CASE(d)                                                        \
  case d:                                                                    \
    return softcap > 0.f                                                     \
               ? launch_hd<T, d, true>(grid, qq, kk, vv, page_idx, span_len, \
                                       tkk, tvv, oo, part, tickets, H, KV,   \
                                       nbt, Tp, tail_len, window, scale,     \
                                       softcap, st)                          \
               : launch_hd<T, d, false>(grid, qq, kk, vv, page_idx,          \
                                        span_len, tkk, tvv, oo, part,        \
                                        tickets, H, KV, nbt, Tp, tail_len,   \
                                        window, scale, softcap, st);
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(128)
    PAGED_CASE(256)
#undef PAGED_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// tk/tv may be null (no tail); bt must be 32, H / KV at most 8 and window
// at least 1. S splits a pair must cover nbt + ceil(Tp / 32) tiles; part
// holds B * KV * S partials of (H / KV) * (hd + 2) floats; tickets holds
// B * KV zeros.
extern "C" int flash_decode_paged_launch(const void* q, const void* pk,
                                         const void* pv, const int* page_idx,
                                         const int* span_len, const void* tk,
                                         const void* tv, void* out,
                                         float* part, int* tickets, int B,
                                         int H, int KV, int hd, int bt,
                                         int nbt, int Tp, int tail_len, int S,
                                         int window, float scale,
                                         float softcap, int dtype,
                                         void* stream) {
  if (bt != kBT || H % KV != 0 || H / KV > kMaxG || window < 1 ||
      !(softcap >= 0.f) ||
      S < n_splits(nbt + (tk ? (Tp + kBT - 1) / kBT : 0)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_typed<float>(q, pk, pv, page_idx, span_len, tk, tv, out,
                               part, tickets, B, H, KV, hd, nbt, Tp, tail_len,
                               S, window, scale, softcap, st);
  return launch_typed<__nv_bfloat16>(q, pk, pv, page_idx, span_len, tk, tv,
                                     out, part, tickets, B, H, KV, hd, nbt, Tp,
                                     tail_len, S, window, scale, softcap, st);
}
