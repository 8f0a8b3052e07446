// Paged flash attention for prefill, for Hopper.
//
// Replaces: src/repro/kernels/flash_prefill.py flash_prefill_paged_kernel
// (the Pallas kernel whose BlockSpec index map resolves KV tile j to
// pool[page_idx[j]] through a scalar-prefetched page table, with the dense
// tail as trailing tiles; body _paged_kernel).
//
// Function: for each sequence b, queries attend over a KV stream that is
// never materialised: its first span_len rows live in a family page pool
// (row r is slot r % bt of page page_idx[b, r / bt]), the next T rows in
// b's dense tail. Column c sits at position c; a query at position p may
// see column c iff c < span_len + T, p - c < window and, when causal,
// p >= c. Queries sit at q_pos[b, i], or at i when q_pos is null (the TPU
// kernel's contract: the queries cover the whole stream). A ragged last
// page's slots past span_len are never read: row span_len is the tail's
// first row. Masked logits are -2^30; the online softmax is
// _softmax_update's (flash_prefill.py:46-66), in f32.
//
// What bounds it: as the dense prefill kernel (bytes in bf16, 0.010 ms at
// the main path's round-2 pool, q [8,256,28,128]; operations in f32, three
// TF32 products a pair), plus one page-table read per staged row (each
// row's 16-byte words are gathered by cp.async from wherever its page
// lies).
//
// Design: one block of prefill::threads<hd>() threads (128; 256 at head
// dim 256) per (64-row q tile, query head, sequence), running prefill::attend (prefill_attn.cuh), the tile code of
// the dense kernel, with PagedRows saying where each row lives. Rows are
// addressed one by one, so the tiles hold the same rows as the dense
// kernel's over the gathered stream and both give the same bits, for any
// span length and any page size. A positive softcap launches the capped
// instance (flash_prefill_paged_capped_kernel), which stays bit-equal to
// the dense kernel's capped instance on the same rows.
#include "prefill_attn.cuh"

using prefill::kBQ;

namespace {

template <typename T, int HD>
struct PagedRows {
  const T* pk;               // [P, bt, KV, HD]
  const T* pv;
  const int* pages;          // page_idx row of sequence b, [nbh]
  const T* tk;               // sequence b's tail, [T, KV, HD], or null
  const T* tv;
  int KV, kvh, bt, span, tail;   // tail: rows in the tail

  __device__ __forceinline__ int len() const { return span + tail; }
  __device__ __forceinline__ bool row(int c, const T*& kr,
                                      const T*& vr) const {
    long long o;
    if (c < span) {
      o = (((long long)pages[c / bt] * bt + c % bt) * KV + kvh) * HD;
      kr = pk + o;
      vr = pv + o;
      return true;
    }
    const int r = c - span;
    if (r >= tail) return false;
    o = ((long long)r * KV + kvh) * HD;
    kr = tk + o;
    vr = tv + o;
    return true;
  }
};

}  // namespace

template <typename T, int HD, bool kCap>
__device__ __forceinline__ void paged_block(
    const T* __restrict__ q, const T* __restrict__ pk,
    const T* __restrict__ pv, const int* __restrict__ page_idx,
    const T* __restrict__ tk, const T* __restrict__ tv, T* __restrict__ out,
    const int* __restrict__ q_pos, int Sq, int H, int KV, int bt, int nbh,
    int span, int tail_rows, int window, int causal, float scale, bool vec,
    float softcap) {
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long tb = (long long)b * tail_rows * KV * HD;
  const PagedRows<T, HD> rows{pk, pv, page_idx + (long long)b * nbh,
                              tk ? tk + tb : nullptr, tv ? tv + tb : nullptr,
                              KV, kvh, bt, span, tail_rows};
  prefill::attend<T, HD, kCap>(q, out, q_pos, tile, h, b, Sq, H, window,
                               causal != 0, scale, softcap, vec, rows);
}

template <typename T, int HD>
__global__ void __launch_bounds__(prefill::threads<HD>())
flash_prefill_paged_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                           const T* __restrict__ pv,
                           const int* __restrict__ page_idx,
                           const T* __restrict__ tk, const T* __restrict__ tv,
                           T* __restrict__ out, const int* __restrict__ q_pos,
                           int Sq, int H, int KV, int bt, int nbh, int span,
                           int tail_rows, int window, int causal, float scale,
                           bool vec, float softcap) {
  paged_block<T, HD, false>(q, pk, pv, page_idx, tk, tv, out, q_pos, Sq, H,
                            KV, bt, nbh, span, tail_rows, window, causal,
                            scale, vec, softcap);
}

// The capped instance, with one block an SM declared (prefill::kCapBlocks)
// so that ptxas may give it the registers it needs without spilling.
template <typename T, int HD>
__global__ void __launch_bounds__(prefill::threads<HD>(), prefill::kCapBlocks)
flash_prefill_paged_capped_kernel(
    const T* __restrict__ q, const T* __restrict__ pk,
    const T* __restrict__ pv, const int* __restrict__ page_idx,
    const T* __restrict__ tk, const T* __restrict__ tv, T* __restrict__ out,
    const int* __restrict__ q_pos, int Sq, int H, int KV, int bt, int nbh,
    int span, int tail_rows, int window, int causal, float scale, bool vec,
    float softcap) {
  paged_block<T, HD, true>(q, pk, pv, page_idx, tk, tv, out, q_pos, Sq, H,
                           KV, bt, nbh, span, tail_rows, window, causal,
                           scale, vec, softcap);
}

// An uncapped instance with one block an SM declared (prefill::one_block).
template <typename T, int HD>
__global__ void __launch_bounds__(prefill::threads<HD>(), prefill::kCapBlocks)
flash_prefill_paged_one_block_kernel(
    const T* __restrict__ q, const T* __restrict__ pk,
    const T* __restrict__ pv, const int* __restrict__ page_idx,
    const T* __restrict__ tk, const T* __restrict__ tv, T* __restrict__ out,
    const int* __restrict__ q_pos, int Sq, int H, int KV, int bt, int nbh,
    int span, int tail_rows, int window, int causal, float scale, bool vec,
    float softcap) {
  paged_block<T, HD, false>(q, pk, pv, page_idx, tk, tv, out, q_pos, Sq, H,
                            KV, bt, nbh, span, tail_rows, window, causal,
                            scale, vec, softcap);
}

template <typename T, int HD, bool kCap>
auto kernel_of() {
  if constexpr (kCap)
    return flash_prefill_paged_capped_kernel<T, HD>;
  else if constexpr (prefill::one_block<T, HD>())
    return flash_prefill_paged_one_block_kernel<T, HD>;
  else
    return flash_prefill_paged_kernel<T, HD>;
}

template <typename T, int HD, bool kCap>
static int launch_hd(dim3 grid, const T* q, const T* pk, const T* pv,
                     const int* page_idx, const T* tk, const T* tv, T* out,
                     const int* q_pos, int Sq, int H, int KV, int bt, int nbh,
                     int span, int tail_rows, int window, int causal,
                     float scale, float softcap, bool vec, cudaStream_t st) {
  constexpr int smem = prefill::smem_bytes<T, HD>();
  const auto kernel = kernel_of<T, HD, kCap>();
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, prefill::threads<HD>(), smem, st>>>(
          q, pk, pv, page_idx, tk, tv, out, q_pos, Sq, H, KV, bt, nbh, span,
          tail_rows, window, causal, scale, vec, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_typed(const void* q, const void* pk, const void* pv,
                        const int* page_idx, const void* tk, const void* tv,
                        void* out, const int* q_pos, int B, int Sq, int H,
                        int KV, int hd, int bt, int nbh, int span, int tail_rows,
                        int window, int causal, float scale, float softcap,
                        cudaStream_t st) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const bool vec = ((uintptr_t)pk | (uintptr_t)pv | (uintptr_t)tk |
                    (uintptr_t)tv) % 16 == 0;
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
               ? launch_hd<T, d, true>(grid, qq, kk, vv, page_idx, tkk, tvv, \
                                       oo, q_pos, Sq, H, KV, bt, nbh, span,  \
                                       tail_rows, window, causal, scale,     \
                                       softcap, vec, st)                     \
               : launch_hd<T, d, false>(grid, qq, kk, vv, page_idx, tkk,     \
                                        tvv, oo, q_pos, Sq, H, KV, bt, nbh,  \
                                        span, tail_rows, window, causal,     \
                                        scale, softcap, vec, st);
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

// tk/tv and q_pos may be null (no tail; query row i at position i).
extern "C" int flash_prefill_paged_launch(
    const void* q, const void* pk, const void* pv, const int* page_idx,
    const void* tk, const void* tv, void* out, const int* q_pos, int B, int Sq,
    int H, int KV, int hd, int bt, int nbh, int span, int tail_rows, int window,
    int causal, float scale, float softcap, int dtype, void* stream) {
  if (!(softcap >= 0.f)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_typed<float>(q, pk, pv, page_idx, tk, tv, out, q_pos, B, Sq,
                               H, KV, hd, bt, nbh, span, tail_rows, window, causal,
                               scale, softcap, st);
  return launch_typed<__nv_bfloat16>(q, pk, pv, page_idx, tk, tv, out, q_pos,
                                     B, Sq, H, KV, hd, bt, nbh, span, tail_rows,
                                     window, causal, scale, softcap, st);
}
