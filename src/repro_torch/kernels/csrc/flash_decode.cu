// Dense single-query decode attention for Hopper.
//
// Replaces: src/repro/kernels/flash_decode.py flash_decode_kernel (the
// Pallas kernel over one sequence's dense [KV, Skp, hd] K/V, grid (H, nk),
// its length-1 query padded to an 8-row sublane tile, the window applied
// by skipping tiles and masking columns).
//
// Function: for each sequence b, its one query per head sits at position
// kv_len[b] - 1 and attends over the rows of its dense cache
// k/v [B, Sk, KV, hd]; column j is allowed iff j < kv_len[b] and
// kv_len[b] - 1 - j < window. kv_len lives on the device, one per
// sequence, so a decode step needs no host sync. This is the serving
// engine's dense decode loop: every decode step of a hybrid (attention +
// SSM) model, and the oracle the paged loop is pinned against.
//
// What bounds it: bytes. Each allowed row is read once per KV head and the
// arithmetic is two flops per loaded element per query head of the group.
//
// Design: the grid is (KV head, sequence, split): one block of 256 threads
// per split of decode::kSplitTiles 32-row tiles of a (KV head, sequence)
// pair covers the G query heads of that KV head (G = 5 for Hymba-1.5B, 7
// for Qwen2.5-7B; past 8, as Llama-3.1-405B's 16, in chunks of 8 over the
// same staged tiles), so the card has KV x B x S blocks to spread the
// cache over (Hymba at Sk 576: 360) and each row is read once per group. Tiles
// run through decode::attend (decode_attn.cuh): a cp.async ring, the tile
// arithmetic, and the fixed-order combine of the splits, shared with the
// paged decode kernel, so paged == dense holds bit for bit whenever the
// two see the same rows. Tiles wholly before the window (rows < kv_len -
// window) or past kv_len are never loaded; masked columns inside a loaded
// tile score -2^30. A positive softcap runs the kCap instance of the
// kernel (the scores capped as decode_attn.cuh says), softcap 0 the
// uncapped one.
#include "decode_attn.cuh"

using decode::kBT;
using decode::kThreads;
using decode::n_splits;

namespace {

// Tile t is rows t*32 .. t*32+31 of sequence b's dense cache. A row past
// the cache (a last tile that Sk cuts) reads row Sk-1 instead: it lies at
// or past kv_len, so it is masked and adds exact zeros.
template <typename T, int HD>
struct DenseRows {
  const T* k;                // sequence b's [Sk, KV, HD] rows
  const T* v;
  int KV, kvh, Sk, kv_len, window;

  __device__ __forceinline__ bool row(int t, int j, const T*& kr,
                                      const T*& vr) const {
    const int r = min(t * kBT + j, Sk - 1);
    const long long o = ((long long)r * KV + kvh) * HD;
    kr = k + o;
    vr = v + o;
    return true;
  }
  __device__ __forceinline__ bool valid(int t, int j) const {
    const int r = t * kBT + j;
    return r < kv_len && kv_len - 1 - r < window;
  }
};

}  // namespace

template <typename T, int HD, bool kCap, bool kWide>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int H, int KV,
    int Sk, int window, float scale, float softcap) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int len = max(min(kv_len[b], Sk), 0);
  const long long base = (long long)b * Sk * KV * HD;
  const DenseRows<T, HD> rows{k + base, v + base, KV, kvh, Sk, len, window};
  // first allowed row: kv_len - window (window >= 1)
  const long long lo = max((long long)len - window, 0LL);
  decode::attend<T, HD, kCap, kWide>(q, out, b, kvh, H, KV, scale, softcap,
                                     (int)(lo / kBT), (len + kBT - 1) / kBT,
                                     rows, part, tickets);
}

template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ tickets, int H, int KV, int Sk,
                    int window, float scale, float softcap) {
  decode_block<T, HD, kCap, false>(q, k, v, kv_len, out, part, tickets, H,
                                   KV, Sk, window, scale, softcap);
}

// More than 8 query heads a KV head (decode::attend's kWide): one block an
// SM declared, as the paged kernel declares it, so that ptxas may give the
// head chunks' loop the registers it needs (held to 64 a thread, the f32
// hd-64 and hd-80 and bf16 hd-80 instances spilled 4-12 bytes).
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ kv_len, T* __restrict__ out,
                         float* __restrict__ part, int* __restrict__ tickets,
                         int H, int KV, int Sk, int window, float scale,
                         float softcap) {
  decode_block<T, HD, kCap, true>(q, k, v, kv_len, out, part, tickets, H,
                                  KV, Sk, window, scale, softcap);
}

template <typename T, int HD, bool kCap, bool kWide>
auto kernel_of() {
  if constexpr (kWide)
    return flash_decode_wide_kernel<T, HD, kCap>;
  else
    return flash_decode_kernel<T, HD, kCap>;
}

template <typename T, int HD, bool kCap, bool kWide>
static int launch_g(dim3 grid, const T* q, const T* k, const T* v,
                    const int* kv_len, T* out, float* part, int* tickets,
                    int H, int KV, int Sk, int window, float scale,
                    float softcap, cudaStream_t st) {
  constexpr int smem = decode::smem_bytes<T, HD, kWide>();
  const auto kernel = kernel_of<T, HD, kCap, kWide>();
  if (smem + decode::static_smem_bytes<HD>() > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, kv_len, out, part, tickets,
                                       H, KV, Sk, window, scale, softcap);
  return (int)cudaGetLastError();
}

// up to 8 heads a KV head run the instance of one chunk, more the
// chunked one
template <typename T, int HD, bool kCap>
static int launch_hd(dim3 grid, const T* q, const T* k, const T* v,
                     const int* kv_len, T* out, float* part, int* tickets,
                     int H, int KV, int Sk, int window, float scale,
                     float softcap, cudaStream_t st) {
  if (H / KV > decode::kMaxG)
    return launch_g<T, HD, kCap, true>(grid, q, k, v, kv_len, out, part,
                                       tickets, H, KV, Sk, window, scale,
                                       softcap, st);
  return launch_g<T, HD, kCap, false>(grid, q, k, v, kv_len, out, part,
                                      tickets, H, KV, Sk, window, scale,
                                      softcap, st);
}

template <typename T>
static int launch_typed(const void* q, const void* k, const void* v,
                        const int* kv_len, void* out, float* part,
                        int* tickets, int B, int H, int KV, int hd, int Sk,
                        int S, int window, float scale, float softcap,
                        cudaStream_t st) {
  dim3 grid(KV, B, S);
  const T* qq = (const T*)q;
  const T* kk = (const T*)k;
  const T* vv = (const T*)v;
  T* oo = (T*)out;
  switch (hd) {
#define DENSE_CASE(d)                                                       \
  case d:                                                                   \
    return softcap > 0.f                                                    \
               ? launch_hd<T, d, true>(grid, qq, kk, vv, kv_len, oo, part,  \
                                       tickets, H, KV, Sk, window, scale,   \
                                       softcap, st)                         \
               : launch_hd<T, d, false>(grid, qq, kk, vv, kv_len, oo, part, \
                                        tickets, H, KV, Sk, window, scale,  \
                                        softcap, st);
    DENSE_CASE(32)
    DENSE_CASE(64)
    DENSE_CASE(80)
    DENSE_CASE(96)
    DENSE_CASE(112)
    DENSE_CASE(128)
    DENSE_CASE(256)
#undef DENSE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// H a multiple of KV (any G = H / KV) and window at least 1. S splits a pair must
// cover ceil(Sk / 32) tiles; part holds B * KV * S partials of
// (H / KV) * (hd + 2) floats; tickets holds B * KV zeros.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* kv_len,
                                   void* out, float* part, int* tickets,
                                   int B, int H, int KV, int hd, int Sk,
                                   int S, int window, float scale,
                                   float softcap, int dtype, void* stream) {
  if (H % KV != 0 || window < 1 || !(softcap >= 0.f) ||
      S < n_splits((Sk + kBT - 1) / kBT))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_typed<float>(q, k, v, kv_len, out, part, tickets, B, H, KV,
                               hd, Sk, S, window, scale, softcap, st);
  return launch_typed<__nv_bfloat16>(q, k, v, kv_len, out, part, tickets, B,
                                     H, KV, hd, Sk, S, window, scale, softcap,
                                     st);
}
