// The backward of the dense flash attention (flash_prefill.cu), for Hopper:
// dQ, dK and dV of ops.flash_attention.
//
// Replaces: no TPU kernel. src/repro/kernels/flash_prefill.py
// flash_prefill_kernel has no backward; the JAX package trains through
// gqa_attention (src/repro/models/layers.py:94-116), whose gradient XLA
// derives from the einsums under jax.value_and_grad
// (src/repro/training/train_loop.py:96). This kernel is the port's
// counterpart of that gradient, so that training never materialises the
// [B, H, Sq, Sk] logits.
//
// Function: with the scaled logits r = q k^T * scale, s = c tanh(r / c)
// under a soft cap c > 0 (else s = r), the forward's mask (column j is
// allowed for a query at p iff 0 <= p - j < window and j < kv_len[b]),
// P = softmax(s) in f32 and D = rowsum(dO * O):
//   dV = P^T dO,  dS = P (dO V^T - D) (1 - tanh^2(r / c)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// dK and dV summed over the G query heads of each KV head. Masked pairs
// contribute exactly zero. ref.flash_attention_bwd_ref is the plain version.
//
// Design (simple and deterministic; no atomics, fixed summation orders, so
// two calls give the same bits). Two kernels on the caller's stream:
//   dq_kernel, one block per (q tile, query head, batch row): D for its
//     rows; a first sweep over the KV tiles the tile can see recomputes
//     each row's max and sum, hence its log-sum-exp (the forward is left
//     as it is and writes none); a second sweep forms P = exp(s - lse),
//     dP = dO V^T and dS, and accumulates dQ += dS K. It writes dQ, and
//     the LSE and D of its rows to the f32 scratch the wrapper allocates.
//   dkv_kernel, one block per (key tile, KV head, batch row): walks the
//     query tiles that can see its keys and, for each, the G query heads,
//     recomputes P and dS from the scratch, and accumulates dV += P^T dO
//     and dK += dS^T Q in registers.
// Tiles are staged in shared memory as f32 whatever the input type (rows
// pitched HD + 1 floats: the 16 rows a half-warp reads fall in 16 banks),
// every product runs as f32 FMAs on the CUDA cores with f32 accumulators,
// and results are rounded to the input type once. 256 threads: thread
// (ty, tx) = (tid / 16, tid % 16) holds the score pairs (ty + 16 a, tx +
// 16 b) and the accumulator cells (row ty + 16 a, dim tx + 16 b). Tiles
// are 64 rows (32 at head dim 256, where four f32 tiles of 64 would not
// fit in shared memory). The heaviest blocks (late query tiles, early key
// tiles under a causal mask) are scheduled first.
//
// What bounds it: operations. The backward is ~2.5x the forward's
// products (dQ, dK, dV, dP and S; this design recomputes S twice more
// and so does 4x), here on the CUDA cores in f32 (67 TFLOP/s) where the
// forward runs on the tensor cores; the tensor-core rewrite (mma.sync on
// the forward's product policies, the LSE written by the forward) is left
// to a later change. See PERF.md.
#include <climits>

#include "common.cuh"

namespace bwd {

constexpr int kThreads = 256;

template <int HD>
__host__ __device__ constexpr int tile() { return HD > 128 ? 32 : 64; }

// rows a thread holds of a tile (a = 0 .. kR - 1: row ty + 16 a)
template <int HD>
__host__ __device__ constexpr int rows() { return tile<HD>() / 16; }

template <int HD>
__host__ __device__ constexpr int pitch() { return HD + 1; }

// shared memory of each kernel, bytes
template <int HD>
__host__ __device__ constexpr int dq_smem() {
  return (4 * tile<HD>() * pitch<HD>() + tile<HD>() * (tile<HD>() + 1)) * 4;
}
template <int HD>
__host__ __device__ constexpr int dkv_smem() {
  return (4 * tile<HD>() * pitch<HD>() + 2 * tile<HD>() * (tile<HD>() + 1)) *
         4;
}

// rows [r0, r0 + n) of a [B*, S, nh, HD] tensor at head h, batch row b, into
// a shared f32 tile (zeros past S)
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int r0, int S, int nh, int h) {
  constexpr int BT = tile<HD>(), P = pitch<HD>();
  for (int idx = threadIdx.x; idx < BT * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD, r = r0 + i;
    dst[i * P + d] =
        r < S ? to_f32(src[(((long long)b * S + r) * nh + h) * HD + d]) : 0.f;
  }
}

// the allowed rule of the forward (prefill_attn.cuh), causal
__device__ __forceinline__ bool allowed(bool valid, int p, int c, int window,
                                        int klen) {
  const int dl = p - c;
  return valid && dl >= 0 && dl < window && c < klen;
}

// s (the raw product) -> (P, the cap's factor 1 - tanh^2), given the row's
// log-sum-exp
template <bool kCap>
__device__ __forceinline__ float prob(float s, float scale, float softcap,
                                      float lse, float& dcap) {
  if constexpr (kCap) {
    const float t = tanhf(s * scale / softcap);
    dcap = 1.f - t * t;
    return expf(softcap * t - lse);
  } else {
    dcap = 1.f;
    return expf(s * scale - lse);
  }
}

// S (and with kDP, dP) of the thread's kR x kR pairs from the shared tiles
template <int HD, bool kDP>
__device__ __forceinline__ void products(
    float (&s)[rows<HD>()][rows<HD>()], float (&dp)[rows<HD>()][rows<HD>()],
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    int ty, int tx) {
  constexpr int R = rows<HD>(), P = pitch<HD>();
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[R], kb[R], da[R], vb[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      qa[a] = Qs[(ty + 16 * a) * P + d];
      kb[a] = Ks[(tx + 16 * a) * P + d];
      if constexpr (kDP) {
        da[a] = dOs[(ty + 16 * a) * P + d];
        vb[a] = Vs[(tx + 16 * a) * P + d];
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
        if constexpr (kDP) dp[a][c] = fmaf(da[a], vb[c], dp[a][c]);
      }
  }
}

// ------------------------------------------------------------- dq_kernel
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ out,
          const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ lse_out, float* __restrict__ dlt_out,
          const int* __restrict__ q_pos, const int* __restrict__ kv_len,
          int Sq, int Sk, int H, int KV, int window, float scale,
          float softcap) {
  constexpr int BT = tile<HD>(), R = rows<HD>(), P = pitch<HD>();
  constexpr int NC = HD / 16;                   // accumulator dims a thread
  constexpr int TPR = kThreads / BT;            // threads a row for D
  extern __shared__ __align__(16) float smem[];
  float* const Qs = smem;
  float* const dOs = Qs + BT * P;
  float* const Ks = dOs + BT * P;
  float* const Vs = Ks + BT * P;
  float* const Ss = Vs + BT * P;                // [BT][BT + 1]: dS
  __shared__ int s_pos[BT];
  __shared__ float s_lse[BT], s_dlt[BT];
  __shared__ int s_qmin, s_qmax;

  const int nq = (Sq + BT - 1) / BT;
  const int qt = nq - 1 - blockIdx.x;           // the heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int r0 = qt * BT;
  const int klen = kv_len ? min(kv_len[b], Sk) : Sk;

  if (tid == 0) { s_qmin = INT_MAX; s_qmax = INT_MIN; }
  stage<T, HD>(Qs, q, b, r0, Sq, H, h);
  stage<T, HD>(dOs, dout, b, r0, Sq, H, h);
  __syncthreads();
  {
    // D = rowsum(dO * O), TPR threads a row (a power of two within a warp)
    const int i = tid / TPR, part = tid % TPR, r = r0 + i;
    float acc = 0.f;
    if (r < Sq) {
      const T* orow = out + (((long long)b * Sq + r) * H + h) * HD;
      for (int d = part; d < HD; d += TPR)
        acc = fmaf(dOs[i * P + d], to_f32(orow[d]), acc);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (part == 0) {
      s_dlt[i] = acc;
      const int p = r < Sq ? q_pos[(long long)b * Sq + r] : 0;
      s_pos[i] = p;
      if (r < Sq) { atomicMin(&s_qmin, p); atomicMax(&s_qmax, p); }
    }
  }
  __syncthreads();

  int t0 = 0, nt = 0;
  if (s_qmin <= s_qmax) {
    const long long lo = (long long)s_qmin - window + 1;
    const int c_lo = lo > 0 ? (int)lo : 0;
    const int c_hi = min(klen, s_qmax + 1);
    t0 = c_lo / BT;
    nt = c_hi > t0 * BT ? (c_hi - t0 * BT + BT - 1) / BT : 0;
  }
  int pa[R];
  bool va[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    va[a] = r0 + ty + 16 * a < Sq;
    pa[a] = s_pos[ty + 16 * a];
  }

  // sweep 1: each row's max and sum (a lane's partial sum over its
  // columns, combined over the 16 lanes of the row at the end)
  float m[R], l[R];
#pragma unroll
  for (int a = 0; a < R; ++a) { m[a] = kNegInf; l[a] = 0.f; }
  for (int t = t0; t < t0 + nt; ++t) {
    const int c0 = t * BT;
    stage<T, HD>(Ks, k, b, c0, Sk, KV, kvh);
    __syncthreads();
    float s[R][R], unused[R][R];
    products<HD, false>(s, unused, Qs, nullptr, Ks, nullptr, ty, tx);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const bool ok = allowed(va[a], pa[a], c0 + tx + 16 * c, window, klen);
        float x = s[a][c] * scale;
        if constexpr (kCap) x = softcap * tanhf(x / softcap);
        s[a][c] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[a], mx);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) ls += expf(s[a][c] - mn);
      l[a] = l[a] * expf(m[a] - mn) + ls;
      m[a] = mn;
    }
    __syncthreads();                             // Ks is restaged next
  }
  float lse[R], dlt[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      l[a] += __shfl_xor_sync(0xffffffffu, l[a], o);
    lse[a] = m[a] + logf(l[a]);
    dlt[a] = s_dlt[ty + 16 * a];
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < R; ++a) s_lse[ty + 16 * a] = lse[a];
  }
  __syncthreads();                               // s_lse is read at the end

  // sweep 2: dS, and dQ += dS K
  float acc[R][NC];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
  for (int t = t0; t < t0 + nt; ++t) {
    const int c0 = t * BT;
    stage<T, HD>(Ks, k, b, c0, Sk, KV, kvh);
    stage<T, HD>(Vs, v, b, c0, Sk, KV, kvh);
    __syncthreads();
    float s[R][R], dp[R][R];
    products<HD, true>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const bool ok = allowed(va[a], pa[a], c0 + tx + 16 * c, window, klen);
        float dcap;
        const float p = prob<kCap>(s[a][c], scale, softcap, lse[a], dcap);
        Ss[(ty + 16 * a) * (BT + 1) + tx + 16 * c] =
            ok ? p * (dp[a][c] - dlt[a]) * dcap : 0.f;
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float kd[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kd[c] = Ks[j * P + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const float ds = Ss[(ty + 16 * a) * (BT + 1) + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(ds, kd[c], acc[a][c]);
      }
    }
    __syncthreads();                             // Ks, Vs, Ss restaged next
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = r0 + ty + 16 * a;
    if (r >= Sq) continue;
    T* row = dq + (((long long)b * Sq + r) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      row[tx + 16 * c] = from_f32<T>(acc[a][c] * scale);
  }
  if (tid < BT && r0 + tid < Sq) {
    const long long o = ((long long)b * H + h) * Sq + r0 + tid;
    lse_out[o] = s_lse[tid];
    dlt_out[o] = s_dlt[tid];
  }
}

// ------------------------------------------------------------ dkv_kernel
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           T* __restrict__ dk, T* __restrict__ dv,
           const float* __restrict__ lse_in, const float* __restrict__ dlt_in,
           const int* __restrict__ q_pos, const int* __restrict__ kv_len,
           int Sq, int Sk, int H, int KV, int window, float scale,
           float softcap) {
  constexpr int BT = tile<HD>(), R = rows<HD>(), P = pitch<HD>();
  constexpr int NC = HD / 16;
  constexpr int PS = BT + 1;
  extern __shared__ __align__(16) float smem[];
  float* const Ks = smem;
  float* const Vs = Ks + BT * P;
  float* const Qs = Vs + BT * P;
  float* const dOs = Qs + BT * P;
  float* const Ps = dOs + BT * P;               // [BT][BT + 1]: P
  float* const Ds = Ps + BT * PS;               // [BT][BT + 1]: dS
  __shared__ int s_pos[BT];
  __shared__ float s_lse[BT], s_dlt[BT];
  __shared__ int s_qmin, s_qmax;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c0 = kt * BT;
  const int klen = kv_len ? min(kv_len[b], Sk) : Sk;
  const int c_last = min(c0 + BT, klen) - 1;    // the tile's last allowed key

  stage<T, HD>(Ks, k, b, c0, Sk, KV, kvh);
  stage<T, HD>(Vs, v, b, c0, Sk, KV, kvh);
  float ak[R][NC], av[R][NC];          // keys ty + 16 a, dims tx + 16 c
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) ak[a][c] = av[a][c] = 0.f;

  const int nq = c0 < klen ? (Sq + BT - 1) / BT : 0;
  for (int qt = 0; qt < nq; ++qt) {
    const int r0 = qt * BT;
    __syncthreads();                             // the last tile's reads done
    if (tid == 0) { s_qmin = INT_MAX; s_qmax = INT_MIN; }
    __syncthreads();
    if (tid < BT) {
      const int r = r0 + tid;
      const int p = r < Sq ? q_pos[(long long)b * Sq + r] : 0;
      s_pos[tid] = p;
      if (r < Sq) { atomicMin(&s_qmin, p); atomicMax(&s_qmax, p); }
    }
    __syncthreads();
    // can any query of this tile see any allowed key of this tile?
    if (s_qmax < c0 || (long long)s_qmin - c_last >= window) continue;
    int pa[R];
    bool va[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      va[a] = r0 + ty + 16 * a < Sq;
      pa[a] = s_pos[ty + 16 * a];
    }
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      if (g) __syncthreads();                    // the last head's reads done
      stage<T, HD>(Qs, q, b, r0, Sq, H, h);
      stage<T, HD>(dOs, dout, b, r0, Sq, H, h);
      if (tid < BT) {
        const int r = r0 + tid;
        const long long o = ((long long)b * H + h) * Sq + r;
        s_lse[tid] = r < Sq ? lse_in[o] : 0.f;
        s_dlt[tid] = r < Sq ? dlt_in[o] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];
      products<HD, true>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const float lse = s_lse[ty + 16 * a], dlt = s_dlt[ty + 16 * a];
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const bool ok =
              allowed(va[a], pa[a], c0 + tx + 16 * c, window, klen);
          float dcap;
          const float p = prob<kCap>(s[a][c], scale, softcap, lse, dcap);
          const int at = (ty + 16 * a) * PS + tx + 16 * c;
          Ps[at] = ok ? p : 0.f;
          Ds[at] = ok ? p * (dp[a][c] - dlt) * dcap : 0.f;
        }
      }
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i], dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 2
      for (int i = 0; i < BT; ++i) {
        float od[NC], qd[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          od[c] = dOs[i * P + tx + 16 * c];
          qd[c] = Qs[i * P + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const float p = Ps[i * PS + ty + 16 * a];
          const float ds = Ds[i * PS + ty + 16 * a];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            av[a][c] = fmaf(p, od[c], av[a][c]);
            ak[a][c] = fmaf(ds, qd[c], ak[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = c0 + ty + 16 * a;
    if (r >= Sk) continue;
    const long long o = (((long long)b * Sk + r) * KV + kvh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[o + tx + 16 * c] = from_f32<T>(ak[a][c] * scale);
      dv[o + tx + 16 * c] = from_f32<T>(av[a][c]);
    }
  }
}

template <typename T, int HD, bool kCap>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* dlt, const int* q_pos, const int* kv_len, int B, int Sq,
           int Sk, int H, int KV, int window, float scale, float softcap,
           cudaStream_t st) {
  constexpr int BT = tile<HD>();
  const auto kq = dq_kernel<T, HD, kCap>;
  const auto kkv = dkv_kernel<T, HD, kCap>;
  cudaError_t e = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dkv_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  kq<<<dim3((Sq + BT - 1) / BT, H, B), kThreads, dq_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout,
      (T*)dq, lse, dlt, q_pos, kv_len, Sq, Sk, H, KV, window, scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (Sk == 0) return 0;
  kkv<<<dim3((Sk + BT - 1) / BT, KV, B), kThreads, dkv_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dk, (T*)dv,
      lse, dlt, q_pos, kv_len, Sq, Sk, H, KV, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, void* dq, void* dk, void* dv, float* lse,
                 float* dlt, const int* q_pos, const int* kv_len, int B,
                 int Sq, int Sk, int H, int KV, int hd, int window,
                 float scale, float softcap, cudaStream_t st) {
  switch (hd) {
#define BWD_CASE(d)                                                          \
  case d:                                                                    \
    return softcap > 0.f                                                     \
               ? launch<T, d, true>(q, k, v, out, dout, dq, dk, dv, lse,     \
                                    dlt, q_pos, kv_len, B, Sq, Sk, H, KV,    \
                                    window, scale, softcap, st)              \
               : launch<T, d, false>(q, k, v, out, dout, dq, dk, dv, lse,    \
                                     dlt, q_pos, kv_len, B, Sq, Sk, H, KV,   \
                                     window, scale, softcap, st);
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    BWD_CASE(256)
#undef BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bwd

// kv_len may be null (every batch row has Sk valid columns); lse and dlt
// are f32 [B, H, Sq] scratch; softcap 0 runs the uncapped instances.
extern "C" int flash_prefill_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dlt,
    const int* q_pos, const int* kv_len, int B, int Sq, int Sk, int H, int KV,
    int hd, int window, float scale, float softcap, int dtype, void* stream) {
  if (!(softcap >= 0.f) || KV <= 0 || H % KV)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return bwd::launch_typed<float>(q, k, v, out, dout, dq, dk, dv,
                                    (float*)lse, (float*)dlt, q_pos, kv_len,
                                    B, Sq, Sk, H, KV, hd, window, scale,
                                    softcap, st);
  return bwd::launch_typed<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv,
                                          (float*)lse, (float*)dlt, q_pos,
                                          kv_len, B, Sq, Sk, H, KV, hd, window,
                                          scale, softcap, st);
}
