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
// per split of decode::kSplitTiles tiles of a (KV head, sequence) pair
// covers the G query heads that share that KV head (G = 7 for
// Qwen2.5-7B; past 8 in chunks of 8 over the same staged tiles), so each
// row is read from device memory once per group, not once per query
// head, and the card has KV x B x S blocks (Qwen at 18
// pages: 288) instead of KV x B (32). Tiles run through decode::attend
// (decode_attn.cuh): a cp.async ring, the tile arithmetic and the
// fixed-order combine of the splits, which the dense decode kernel
// (flash_decode.cu) shares.
//
// Any page size bt >= 1. decode::attend's tile stays 32 rows (it is the
// dense kernel's, and the warp's width), and the tiles cover POSITIONS,
// not pages: tile t holds positions t*32 .. t*32+31, and the row at
// position c < span reads slot c % bt of page page_idx[b, c / bt], the
// row at c >= span tail row c - span. So a tile may take rows from
// several pages (bt < 32), from a part of one page (bt > 32, or a bt
// that does not divide 32), or from the last page and the tail at once,
// as csrc/flash_prefill_paged.cu's PagedRows does for the prefill. The
// pair visits tiles 0 .. ceil((qpos + 1) / 32) - 1; as in the dense
// kernel, tiles wholly before the window are never loaded: the first
// tile is the one that holds position qpos - window + 1, and splits count
// from it. Tile t therefore holds the same positions under the same masks
// as the dense kernel's tile t over the gathered rows, at every page size
// and span: the two compute the same bits, capped (softcap > 0, the kCap
// instance) or not. At bt 32 with no tail, tile t is page t.
#include "decode_attn.cuh"

using decode::kBT;
using decode::kThreads;
using decode::n_splits;

namespace {

// c / bt without a division instruction: (umulhi(c, mul) + c) >> shift,
// with shift = ceil(log2 bt) and mul = 2^32 (2^shift - bt) / bt + 1
// (Granlund and Montgomery's round-up method; exact for 0 <= c < 2^31).
struct PageDiv {
  int bt;
  unsigned mul;
  int shift;
};

static PageDiv page_div(int bt) {
  int shift = 0;
  while ((1LL << shift) < bt) ++shift;
  const unsigned long long mul =
      ((1ULL << 32) * ((1ULL << shift) - (unsigned long long)bt)) /
          (unsigned long long)bt + 1;
  return PageDiv{bt, (unsigned)mul, shift};
}

// Tile t is positions t*32 .. t*32+31 of sequence b: position c < span
// is slot c % bt of page pages[c / bt], position c >= span tail row
// c - span. A row past both (c - span >= Tp, or no tail) is staged as
// zeros; it lies past qpos, so it is masked.
template <typename T, int HD>
struct PagedRows {
  const T* pk;
  const T* pv;
  const int* pages;          // page_idx row of sequence b
  const T* tk;               // sequence b's tail, or null
  const T* tv;
  PageDiv div;
  int KV, kvh, Tp, span, qpos, window;

  __device__ __forceinline__ bool row(int t, int j, const T*& k,
                                      const T*& v) const {
    const int c = t * kBT + j;
    long long o;
    if (c < span) {
      const int p =
          (int)((__umulhi((unsigned)c, div.mul) + (unsigned)c) >> div.shift);
      o = (((long long)pages[p] * div.bt + (c - p * div.bt)) * KV + kvh) *
          HD;
      k = pk + o;
      v = pv + o;
      return true;
    }
    const int r = c - span;
    if (r >= Tp) return false;
    o = ((long long)r * KV + kvh) * HD;
    k = tk + o;
    v = tv + o;
    return true;
  }
  // every position up to the query's is a key (pages, then the tail)
  __device__ __forceinline__ bool valid(int t, int j) const {
    const int c = t * kBT + j;
    return c <= qpos && qpos - c < window;
  }
};

}  // namespace

// __launch_bounds__(kThreads, 1) lets ptxas give a thread more than 64
// registers: with the bound on threads alone it held every instance to 64
// once each staged row computed its own page, and the f32 hd-256 instance
// spilled. With it (and PageDiv's multiply for c / bt) no instance spills,
// and the times at 32-row pages are those of the kernel that took only
// 32-row pages (PERF.md §6, row 4).
template <typename T, int HD, bool kCap, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                          const T* __restrict__ pv, const int* __restrict__ page_idx,
                          const int* __restrict__ span_len,
                          const T* __restrict__ tk, const T* __restrict__ tv,
                          T* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ tickets, int H, int KV,
                          PageDiv div, int nbt, int Tp, int tail_len,
                          int window, float scale, float softcap) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  // the span is clamped to the table (an out-of-range span_len reads no
  // page outside it and no split past the scratch the host sized)
  const int span = max(min(span_len[b], nbt * div.bt), 0);
  const int tl = tk ? min(tail_len, Tp) : 0;
  const int qpos = span + tl - 1;
  const long long tail_off = (long long)b * Tp * KV * HD;
  const PagedRows<T, HD> rows{pk, pv, page_idx + (long long)b * nbt,
                              tk ? tk + tail_off : nullptr,
                              tv ? tv + tail_off : nullptr,
                              div, KV, kvh, tk ? Tp : 0, span, qpos,
                              window};
  // the first tile with an allowed column: the one that holds position
  // lo = qpos - window + 1 (window >= 1), as in the dense kernel
  const long long lo = max((long long)qpos - window + 1, 0LL);
  const int t_end = (qpos + kBT) / kBT;
  decode::attend<T, HD, kCap, kWide>(q, out, b, kvh, H, KV, scale, softcap,
                                     min((int)(lo / kBT), t_end), t_end, rows,
                                     part, tickets);
}

template <typename T, int HD, bool kCap, bool kWide>
static int launch_g(dim3 grid, const T* q, const T* pk, const T* pv,
                    const int* page_idx, const int* span_len, const T* tk,
                    const T* tv, T* out, float* part, int* tickets, int H,
                    int KV, PageDiv div, int nbt, int Tp, int tail_len,
                    int window, float scale, float softcap,
                    cudaStream_t st) {
  constexpr int smem = decode::smem_bytes<T, HD, kWide>();
  if (smem + decode::static_smem_bytes<HD>() > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_paged_kernel<T, HD, kCap, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_decode_paged_kernel<T, HD, kCap, kWide>
      <<<grid, kThreads, smem, st>>>(q, pk, pv, page_idx, span_len, tk, tv,
                                     out, part, tickets, H, KV, div, nbt, Tp,
                                     tail_len, window, scale, softcap);
  return (int)cudaGetLastError();
}

// up to 8 heads a KV head run the instance of one chunk, more the
// chunked one
template <typename T, int HD, bool kCap>
static int launch_hd(dim3 grid, const T* q, const T* pk, const T* pv,
                     const int* page_idx, const int* span_len, const T* tk,
                     const T* tv, T* out, float* part, int* tickets, int H,
                     int KV, PageDiv div, int nbt, int Tp, int tail_len,
                     int window, float scale, float softcap,
                     cudaStream_t st) {
  if (H / KV > decode::kMaxG)
    return launch_g<T, HD, kCap, true>(grid, q, pk, pv, page_idx, span_len,
                                       tk, tv, out, part, tickets, H, KV, div,
                                       nbt, Tp, tail_len, window, scale,
                                       softcap, st);
  return launch_g<T, HD, kCap, false>(grid, q, pk, pv, page_idx, span_len,
                                      tk, tv, out, part, tickets, H, KV, div,
                                      nbt, Tp, tail_len, window, scale,
                                      softcap, st);
}

template <typename T>
static int launch_typed(const void* q, const void* pk, const void* pv,
                        const int* page_idx, const int* span_len,
                        const void* tk, const void* tv, void* out,
                        float* part, int* tickets, int B, int H, int KV,
                        int hd, PageDiv bt, int nbt, int Tp, int tail_len,
                        int S,
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
                                       bt, nbt, Tp, tail_len, window, scale, \
                                       softcap, st)                          \
               : launch_hd<T, d, false>(grid, qq, kk, vv, page_idx,          \
                                        span_len, tkk, tvv, oo, part,        \
                                        tickets, H, KV, bt, nbt, Tp,         \
                                        tail_len, window, scale, softcap,    \
                                        st);
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(80)
    PAGED_CASE(96)
    PAGED_CASE(112)
    PAGED_CASE(128)
    PAGED_CASE(256)
#undef PAGED_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// tk/tv may be null (no tail); bt (rows a page) at least 1, H a multiple
// of KV (any G = H / KV) and window at least 1. S splits a pair must cover
// ceil((nbt * bt + Tp) / 32) tiles (Tp counted only with a tail); part
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
  if (bt < 1 || nbt < 0 || Tp < 0 || H % KV != 0 || window < 1 ||
      !(softcap >= 0.f) ||
      S < n_splits((int)(((long long)nbt * bt + (tk ? Tp : 0) + kBT - 1) /
                         kBT)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_typed<float>(q, pk, pv, page_idx, span_len, tk, tv, out,
                               part, tickets, B, H, KV, hd, page_div(bt),
                               nbt, Tp, tail_len, S, window, scale, softcap,
                               st);
  return launch_typed<__nv_bfloat16>(q, pk, pv, page_idx, span_len, tk, tv,
                                     out, part, tickets, B, H, KV, hd,
                                     page_div(bt), nbt, Tp, tail_len, S,
                                     window, scale, softcap, st);
}
