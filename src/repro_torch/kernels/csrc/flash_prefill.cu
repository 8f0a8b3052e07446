// Flash attention for prefill and selective recompute, for Hopper.
//
// Replaces: src/repro/kernels/flash_prefill.py flash_prefill_kernel (the
// Pallas causal / windowed GQA kernel, grid (H, nq, nk) with the online
// softmax carried in VMEM scratch across the sequential KV axis).
//
// Function: queries at arbitrary positions q_pos[b, i] attend over a dense
// KV whose column j sits at position j. Column j is allowed iff
// 0 <= q_pos - j < window and j < kv_len[b]. With q_pos = arange(S) this is
// the TPU kernel's causal prefill; with sorted selected positions it is
// the PIC selective layers' attention, which the TPU kernel cannot express.
// Masked logits are -2^30 and the online-softmax recurrence is the one of
// _softmax_update (flash_prefill.py:46-66), in f32.
//
// What bounds it at the serving path's shapes (S of a few hundred, hd 128):
// in bf16 the bytes (0.021 ms for q [8,544,28,128] causal, against 0.017 ms
// of tensor-core operations); in f32 the operations (three TF32 products
// a pair: 0.103 ms at 495 TFLOP/s, against 0.254 ms of plain f32 on the
// CUDA cores). Both types run on the tensor cores: mma.sync over a
// cp.async ring of K/V tiles in their own type, f32 as split TF32
// (3xTF32), which keeps the f32 tolerance where one TF32 product would
// not. What the tile function still lacks is wgmma's rate. See
// prefill_attn.cuh and PERF.md.
//
// Design: one block of 128 threads (256 at head dim 256, two warps a row
// group, each with half the output columns) per (64-row q tile, query
// head, batch row), running prefill::attend (prefill_attn.cuh, whose tile
// code the paged prefill kernel shares) over a dense KV: column c is row
// c of batch row b, loaded as zeros at c >= Sk. A launch takes the tile
// function's dynamic shared memory (prefill::smem_bytes at head dim 128:
// the ring, 68 KB in bf16; the ring and Q, 101 KB in f32; at head dim 256
// 165 KB in bf16 and 197 KB in f32, one block an SM).
#include "prefill_attn.cuh"

using prefill::kBQ;

namespace {

template <typename T, int HD>
struct DenseRows {
  const T* k;                // batch row b, [Sk, KV, HD]
  const T* v;
  int KV, kvh, Sk, klen;

  __device__ __forceinline__ int len() const { return klen; }
  __device__ __forceinline__ bool row(int c, const T*& kr,
                                      const T*& vr) const {
    if (c >= Sk) return false;
    const long long o = ((long long)c * KV + kvh) * HD;
    kr = k + o;
    vr = v + o;
    return true;
  }
};

}  // namespace

template <typename T, int HD>
__global__ void __launch_bounds__(prefill::threads<HD>())
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     const int* __restrict__ q_pos, const int* __restrict__ kv_len,
                     int Sq, int Sk, int H, int KV, int window, float scale,
                     bool vec) {
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long base = (long long)b * Sk * KV * HD;
  const DenseRows<T, HD> rows{k + base, v + base, KV, kvh, Sk,
                              kv_len ? min(kv_len[b], Sk) : Sk};
  prefill::attend<T, HD>(q, out, q_pos, tile, h, b, Sq, H, window, true,
                         scale, vec, rows);
}

template <typename T, int HD>
static int launch_hd(dim3 grid, const T* q, const T* k, const T* v, T* out,
                     const int* q_pos, const int* kv_len, int Sq, int Sk,
                     int H, int KV, int window, float scale, bool vec,
                     cudaStream_t st) {
  constexpr int smem = prefill::smem_bytes<T, HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_prefill_kernel<T, HD><<<grid, prefill::threads<HD>(), smem, st>>>(
      q, k, v, out, q_pos, kv_len, Sq, Sk, H, KV, window, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_typed(const void* q, const void* k, const void* v, void* out,
                        const int* q_pos, const int* kv_len, int B, int Sq,
                        int Sk, int H, int KV, int hd, int window, float scale,
                        cudaStream_t st) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const bool vec = ((uintptr_t)k % 16 == 0) && ((uintptr_t)v % 16 == 0);
  const T* qq = (const T*)q;
  const T* kk = (const T*)k;
  const T* vv = (const T*)v;
  T* oo = (T*)out;
  switch (hd) {
#define PREFILL_CASE(d)                                                      \
  case d:                                                                    \
    return launch_hd<T, d>(grid, qq, kk, vv, oo, q_pos, kv_len, Sq, Sk, H,   \
                           KV, window, scale, vec, st);
    PREFILL_CASE(32)
    PREFILL_CASE(64)
    PREFILL_CASE(128)
    PREFILL_CASE(256)
#undef PREFILL_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// kv_len may be null (every batch row has Sk valid columns).
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    void* out, const int* q_pos,
                                    const int* kv_len, int B, int Sq, int Sk,
                                    int H, int KV, int hd, int window,
                                    float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_typed<float>(q, k, v, out, q_pos, kv_len, B, Sq, Sk, H, KV,
                               hd, window, scale, st);
  return launch_typed<__nv_bfloat16>(q, k, v, out, q_pos, kv_len, B, Sq, Sk,
                                     H, KV, hd, window, scale, st);
}
