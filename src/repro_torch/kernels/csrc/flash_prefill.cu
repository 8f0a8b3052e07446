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
// neither bytes nor tensor-core flops — this first version runs its dot
// products on the CUDA cores (no mma/wgmma), so it is bound by f32 FMA and
// shared-memory issue. wgmma/TMA is later work; see PERF.md.
//
// Design: one block of 128 threads per (64-row q tile, query head, batch
// row). Two threads share a query row, each holding half of q and of the
// accumulator in registers (interleaved float2 pairs, so the pair reads
// two adjacent 8-byte words of a K/V row: no bank conflict, and the 16
// rows of a warp broadcast). The block loops over 32-row KV tiles of the
// KV head h / G, staged in shared memory as f32. A tile's 32 scores are
// computed, masked, folded into the running (max, sum) at once and applied
// to the accumulator. Tiles wholly outside the tile's band [min q_pos -
// window + 1, max q_pos] or past kv_len are never loaded.
#include "common.cuh"

#include <climits>

namespace {
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // KV rows per shared-memory tile
constexpr int kThreads = 128;
}  // namespace

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     const int* __restrict__ q_pos, const int* __restrict__ kv_len,
                     int Sq, int Sk, int H, int KV, int window, float scale) {
  constexpr int NP = HD / 4;   // float2 pairs held per thread
  __shared__ __align__(16) float Ks[kBK][HD];
  __shared__ __align__(16) float Vs[kBK][HD];
  __shared__ int s_qmin, s_qmax;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int part = tid & 1;
  const int row = tile * kBQ + (tid >> 1);
  const bool valid_row = row < Sq;
  const int qp = valid_row ? q_pos[(long long)b * Sq + row] : 0;
  const int klen = kv_len ? min(kv_len[b], Sk) : Sk;

  if (tid == 0) { s_qmin = INT_MAX; s_qmax = INT_MIN; }
  __syncthreads();
  if (valid_row && part == 0) { atomicMin(&s_qmin, qp); atomicMax(&s_qmax, qp); }

  float2 qv[NP], acc[NP];
  const long long qo = (((long long)b * Sq + row) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int d = 4 * i + 2 * part;
    qv[i] = valid_row ? make_float2(to_f32(q[qo + d]), to_f32(q[qo + d + 1]))
                      : make_float2(0.f, 0.f);
    acc[i] = make_float2(0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;
  __syncthreads();

  const long long lo = (long long)s_qmin - window + 1;
  const int c_lo = lo > 0 ? (int)lo : 0;
  const int c_hi = min(klen, s_qmax + 1);   // exclusive
  for (int c0 = (c_lo / kBK) * kBK; c0 < c_hi; c0 += kBK) {
    __syncthreads();
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const int c = c0 + j;
      float kk = 0.f, vv = 0.f;
      if (c < Sk) {
        const long long o = (((long long)b * Sk + c) * KV + kvh) * HD + d;
        kk = to_f32(k[o]);
        vv = to_f32(v[o]);
      }
      Ks[j][d] = kk;
      Vs[j][d] = vv;
    }
    __syncthreads();

    float s[kBK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float2* kr = reinterpret_cast<const float2*>(Ks[j]);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float2 kk = kr[2 * i + part];
        dot += qv[i].x * kk.x + qv[i].y * kk.y;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const int c = c0 + j;
      const int dl = qp - c;
      const bool ok = valid_row && dl >= 0 && dl < window && c < klen;
      s[j] = ok ? dot * scale : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      lsum += s[j];
    }
    l = alpha * l + lsum;
#pragma unroll
    for (int i = 0; i < NP; ++i) { acc[i].x *= alpha; acc[i].y *= alpha; }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
      const float2* vr = reinterpret_cast<const float2*>(Vs[j]);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float2 vv = vr[2 * i + part];
        acc[i].x += p * vv.x;
        acc[i].y += p * vv.y;
      }
    }
    m = m_new;
  }

  if (valid_row) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int d = 4 * i + 2 * part;
      out[qo + d] = from_f32<T>(acc[i].x * inv);
      out[qo + d + 1] = from_f32<T>(acc[i].y * inv);
    }
  }
}

template <typename T>
static int launch_typed(const void* q, const void* k, const void* v, void* out,
                        const int* q_pos, const int* kv_len, int B, int Sq,
                        int Sk, int H, int KV, int hd, int window, float scale,
                        cudaStream_t st) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const T* qq = (const T*)q;
  const T* kk = (const T*)k;
  const T* vv = (const T*)v;
  T* oo = (T*)out;
  switch (hd) {
    case 32:
      flash_prefill_kernel<T, 32><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, oo, q_pos, kv_len, Sq, Sk, H, KV, window, scale);
      break;
    case 64:
      flash_prefill_kernel<T, 64><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, oo, q_pos, kv_len, Sq, Sk, H, KV, window, scale);
      break;
    case 128:
      flash_prefill_kernel<T, 128><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, oo, q_pos, kv_len, Sq, Sk, H, KV, window, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
