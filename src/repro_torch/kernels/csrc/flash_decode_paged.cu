// Paged single-query decode attention for Hopper.
//
// Replaces: src/repro/kernels/flash_decode.py flash_decode_paged_kernel (the
// Pallas kernel whose BlockSpec index map resolves KV tile j to
// pool[page_idx[j]] through a scalar-prefetched page table, one grid row
// per query head).
//
// Function: for each sequence b, its one query per head attends over the
// pages page_idx[b, :] (columns t*bt + j valid iff < span_len[b]) and then
// over dense tail tiles (valid iff tail row < tail_len). The query sits
// after every valid column, so validity is the only mask. Lengths live on
// the device, one per sequence, so a decode step needs no host sync.
//
// What bounds it: bytes. Each valid page is read once per KV head and the
// arithmetic is two flops per loaded element per query head of the group.
//
// Design: one block of 128 threads per (KV head, sequence) covers the G
// query heads that share that KV head (G = 7 for Qwen2.5-7B), so each page
// is read from device memory once per group, not once per query head. The
// block walks only the ceil(span_len / bt) pages the sequence needs, then
// the tail. A page (bt = 32 rows) is staged in shared memory as f32 with a
// padded row stride (hd + 1) so the per-key dot products of a warp hit 32
// different banks. Scores for the G x 32 (head, key) pairs are computed
// one pair per thread; one warp per head folds them into the running
// (max, sum) of the online softmax with shuffles; then the G x hd
// accumulator in shared memory is rescaled and updated.
#include "common.cuh"

namespace {
constexpr int kBT = 32;       // page rows == warp width
constexpr int kMaxG = 8;      // query heads per KV head
constexpr int kThreads = 128;
}  // namespace

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                          const T* __restrict__ pv, const int* __restrict__ page_idx,
                          const int* __restrict__ span_len,
                          const T* __restrict__ tk, const T* __restrict__ tv,
                          T* __restrict__ out, int H, int KV, int nbt, int Tp,
                          int tail_len, float scale) {
  __shared__ float qs[kMaxG][HD];
  __shared__ float Ks[kBT][HD + 1];
  __shared__ float Vs[kBT][HD + 1];
  __shared__ float ps[kMaxG][kBT];
  __shared__ float acc[kMaxG][HD];
  __shared__ float m_s[kMaxG], l_s[kMaxG], a_s[kMaxG];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    qs[g][d] = to_f32(q[((long long)b * H + kvh * G + g) * HD + d]);
    acc[g][d] = 0.f;
  }
  if (tid < G) { m_s[tid] = kNegInf; l_s[tid] = 0.f; }

  const int span = span_len[b];
  const int npages = min((span + kBT - 1) / kBT, nbt);
  const int ntail = tk ? (tail_len + kBT - 1) / kBT : 0;
  for (int t = 0; t < npages + ntail; ++t) {
    const bool is_page = t < npages;
    const int tt = t - npages;
    __syncthreads();
    const long long page = is_page ? (long long)page_idx[(long long)b * nbt + t] : 0;
    for (int idx = tid; idx < kBT * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      float kk = 0.f, vv = 0.f;
      if (is_page) {
        const long long o = ((page * kBT + j) * KV + kvh) * HD + d;
        kk = to_f32(pk[o]);
        vv = to_f32(pv[o]);
      } else if (tt * kBT + j < Tp) {
        const long long o = (((long long)b * Tp + tt * kBT + j) * KV + kvh) * HD + d;
        kk = to_f32(tk[o]);
        vv = to_f32(tv[o]);
      }
      Ks[j][d] = kk;
      Vs[j][d] = vv;
    }
    __syncthreads();
    for (int idx = tid; idx < G * kBT; idx += kThreads) {
      const int g = idx / kBT, j = idx % kBT;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += qs[g][d] * Ks[j][d];
      const bool ok = is_page ? (t * kBT + j < span) : (tt * kBT + j < tail_len);
      ps[g][j] = ok ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      const float x = ps[g][lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = expf(x - m_new);
      const float sum = warp_sum(p);
      ps[g][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * HD; idx += kThreads) {
      const int g = idx / HD, d = idx % HD;
      float a = acc[g][d] * a_s[g];
#pragma unroll 8
      for (int j = 0; j < kBT; ++j) a += ps[g][j] * Vs[j][d];
      acc[g][d] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    out[((long long)b * H + kvh * G + g) * HD + d] =
        from_f32<T>(acc[g][d] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
static int launch_typed(const void* q, const void* pk, const void* pv,
                        const int* page_idx, const int* span_len,
                        const void* tk, const void* tv, void* out, int B,
                        int H, int KV, int hd, int nbt, int Tp, int tail_len,
                        float scale, cudaStream_t st) {
  dim3 grid(KV, B);
  const T* qq = (const T*)q;
  const T* kk = (const T*)pk;
  const T* vv = (const T*)pv;
  const T* tkk = (const T*)tk;
  const T* tvv = (const T*)tv;
  T* oo = (T*)out;
  switch (hd) {
    case 32:
      flash_decode_paged_kernel<T, 32><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, page_idx, span_len, tkk, tvv, oo, H, KV, nbt, Tp,
          tail_len, scale);
      break;
    case 64:
      flash_decode_paged_kernel<T, 64><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, page_idx, span_len, tkk, tvv, oo, H, KV, nbt, Tp,
          tail_len, scale);
      break;
    case 128:
      flash_decode_paged_kernel<T, 128><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, page_idx, span_len, tkk, tvv, oo, H, KV, nbt, Tp,
          tail_len, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// tk/tv may be null (no tail); bt must be 32 and H / KV at most 8.
extern "C" int flash_decode_paged_launch(const void* q, const void* pk,
                                         const void* pv, const int* page_idx,
                                         const int* span_len, const void* tk,
                                         const void* tv, void* out, int B,
                                         int H, int KV, int hd, int bt,
                                         int nbt, int Tp, int tail_len,
                                         float scale, int dtype, void* stream) {
  if (bt != kBT || H % KV != 0 || H / KV > kMaxG) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_typed<float>(q, pk, pv, page_idx, span_len, tk, tv, out, B,
                               H, KV, hd, nbt, Tp, tail_len, scale, st);
  return launch_typed<__nv_bfloat16>(q, pk, pv, page_idx, span_len, tk, tv,
                                     out, B, H, KV, hd, nbt, Tp, tail_len,
                                     scale, st);
}
