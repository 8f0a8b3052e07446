// The f32-activation x bf16-weight linear product on Hopper's tensor cores.
//
// Replaces no TPU kernel: the JAX package leaves jnp's einsum of an f32
// activation and a bf16 weight to XLA. The port served it as a cast of the
// whole weight to a new f32 tensor and a CUDA-core f32 GEMM (TF32 off) at
// every use; from round 1 on the residual stream is f32 (the recovered KV
// is), so every linear product of a served model takes this path.
//
// Function: out[M, N] = x[M, K] @ w[K, N] in f32, x f32 and w bf16, both
// row-major (w in the layout of every stacked weight slice and of
// lm_head), K and N multiples of 8.
//
// Arithmetic: a bf16 weight is exact in bf16, and each f32 activation is
// split exactly into three bf16 parts by truncation, x0 = the upper 16
// bits of x, x1 = the upper 16 bits of x - x0, x2 = x - x0 - x1 (at most 8
// significant bits, so exact in bf16): both subtractions are exact in f32
// and 3 x 8 significand bits cover f32's 24, so x0 + x1 + x2 == x for
// every x that is a multiple of 2^-133 (every |x| >= 2^-110; below that
// the parts lose what lies under bf16's least subnormal). Truncation
// never overflows (a rounded x0 of x near FLT_MAX would be inf). Each
// x_i * w is a product of two 8-bit significands, exact in f32, so three
// bf16 tensor-core products give the f32 product up to summation order.
// For inf and NaN, x1 = x2 = 0, so they propagate as in the f32 product
// (x0 of a quiet NaN is a bf16 NaN). The parts are made in registers, once
// a k-step, from the A fragments a warp reads. A stage's products go into
// a fresh f32 fragment that is then added to the running sum in f32
// (tile_product says why).
//
// One algorithm, two tile configurations, chosen by M alone:
//   Stream (M <= 16: a decode step's rows): bound by the weight's bytes.
//     One 16 x 128 tile a block, its 4 warps each taking one k16 step of
//     every 64-row k tile (mma.sync), two blocks an SM.
//   Compute (M > 16: recovery's B x S rows): bound by the tensor cores'
//     rate, a third of bf16's 989 TFLOP/s. One warpgroup a 64 x 128 tile,
//     each k16 step's three products by wgmma (A from registers, B read
//     from shared memory in the 128-byte swizzle), two blocks an SM;
//     mma.sync reached 34 % of that bound at the cells' recovery shapes,
//     wgmma 42-46 %.
// The work is the (output tile, k tile) pairs: a block takes a whole tile,
// or where the tiles alone leave the card's blocks idle (every decode
// product, wk / wv at N 512 too) a balanced share of the pairs (stream-K);
// blocks that share a tile add their f32 partials in a fixed order, the
// last to take the tile's ticket (no float atomics: two calls give the
// same bits). Tiles are grouped 8 row tiles at a time so that the tiles a
// wave works on share x rows and w columns in L2. x (f32) and w (bf16, in
// its own layout: no f32 copy of a weight exists anywhere) come through a
// ring of cp.async stages: x's A fragments by 8-byte loads from rows
// pitched BK + 8 floats (the 16 lanes of a half warp hit 32 banks), w's B
// fragments by ldmatrix.trans from padded rows (mma.sync; prefill_attn.cuh's
// P V step) or by wgmma from swizzled atoms.
#include <cfloat>

#include "prefill_attn.cuh"

namespace mixed {

using bf16 = __nv_bfloat16;
using prefill::ldmatrix_x4_trans;

// The truncations of a (low half) and b (high half) to bf16, packed as
// one fragment register.
__device__ __forceinline__ uint32_t upper_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ float rest(float a) {
  return a - __uint_as_float(__float_as_uint(a) & 0xffff0000u);
}

// Columns (a, b) of a fragment as three bf16 fragment registers whose sum
// is (a, b) exactly; the rest of inf or NaN is 0.
__device__ __forceinline__ void split3(float a, float b, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  p0 = upper_halves(a, b);
  const float ra = fabsf(a) <= FLT_MAX ? rest(a) : 0.f;
  const float rb = fabsf(b) <= FLT_MAX ? rest(b) : 0.f;
  p1 = upper_halves(ra, rb);
  p2 = upper_halves(rest(ra), rest(rb));
}

template <int BM_, int BN_, int BK_, int WarpsM, int WarpsN, int WarpsK,
          int ChainN, int Stages, int MinBlocks, bool Wgmma = false>
struct Config {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, kChainN = ChainN;
  static constexpr bool kWgmma = Wgmma;
  static constexpr int kStages = Stages, kMinBlocks = MinBlocks;
  static constexpr int kWarpsM = WarpsM, kWarpsN = WarpsN, kWarpsK = WarpsK;
  static constexpr int kThreads = 32 * WarpsM * WarpsN * WarpsK;
  static constexpr int kWM = BM / WarpsM, kWN = BN / WarpsN;
  static constexpr int kMT = kWM / 16, kNT = kWN / 8;  // m16 / n8 tiles
  static constexpr int kPA = BK + 8;    // floats a row of the x tile
  static constexpr int kPB = BN + 8;    // bf16 a row of the w tile
  static constexpr int kABytes = BM * kPA * 4;
  static constexpr int kStage = kABytes + BK * kPB * 2;
  // wgmma's swizzle atoms are 1024-byte aligned: so are its stages, and the
  // ring starts at the first 1024-byte boundary of the dynamic allocation
  static constexpr int kAlign = Wgmma ? 1024 : 16;
  static constexpr int kStride = (kStage + kAlign - 1) / kAlign * kAlign;
  static constexpr int kSmem = Stages * kStride + kAlign - 16;
  static_assert(!Wgmma || kABytes % 1024 == 0, "1024-byte aligned B tiles");
  static_assert(kWM % 16 == 0 && kWN % 16 == 0 && BK % (16 * WarpsK) == 0 &&
                kNT % ChainN == 0 && ChainN % 2 == 0, "tiles");
  // wgmma: one warpgroup, each warp 16 rows x all 128 columns
  static_assert(!Wgmma || (WarpsM == 4 && WarpsN == 1 && WarpsK == 1 &&
                           BM == 64 && BN == 128 && BK % 16 == 0),
                "the wgmma tiles");
  static_assert((BM * BK / 4) % kThreads == 0 &&
                (BK * BN / 8) % kThreads == 0, "whole copies a thread");
  // the k-split warps' sums meet in the ring once it is drained
  static_assert((WarpsK - 1) * WarpsM * WarpsN * 32 * kMT * kNT * 16 <=
                kSmem, "room for the warps' sums");
};

// Stream: 4 warps share each 16 x 128 tile, each taking one k16 step of
// every 64-wide k tile (one split of the A fragment a warp, no repeats),
// and add their sums at the end; mma.sync, 8 fresh fragments at a time
// (ChainN column tiles). Compute: one warpgroup a 64 x 128 tile, each
// k16 step's three products by wgmma with B read from shared memory
// (ChainN unused). Chosen on the card among 13 stream and 15 compute
// variants (tiles, stages, blocks an SM).
//                     BM   BN   BK  warps m, n, k  chain  stages  blocks
using Stream = Config<16, 128, 64, 1, 1, 4, 8, 4, 2>;
using Compute = Config<64, 128, 64, 4, 1, 1, 2, 3, 2, true>;

constexpr int kGroupM = 8;   // row tiles a raster group (Compute)

// k tile kt (BK columns of x, BK rows of w) of the block's (m0, n0) tile
// into one ring stage; whatever lies past M, N or K is zero-filled.
template <class C>
__device__ __forceinline__ void load_tile(float* As, bf16* Bs,
                                          const float* __restrict__ x,
                                          const bf16* __restrict__ w, int M,
                                          int N, int K, int m0, int n0,
                                          int k0, int tid) {
#pragma unroll
  for (int j = 0; j < C::BM * C::BK / 4 / C::kThreads; ++j) {
    const int i = tid + j * C::kThreads;
    const int r = i / (C::BK / 4), c = i % (C::BK / 4) * 4;
    const bool in = m0 + r < M && k0 + c < K;
    cp_async16(As + r * C::kPA + c,
               in ? x + (long long)(m0 + r) * K + k0 + c : x, in);
  }
#pragma unroll
  for (int j = 0; j < C::BK * C::BN / 8 / C::kThreads; ++j) {
    const int i = tid + j * C::kThreads;
    const int r = i / (C::BN / 8), c = i % (C::BN / 8) * 8;
    const bool in = k0 + r < K && n0 + c < N;
    // wgmma reads B in 128-byte swizzle atoms (smem_desc); mma.sync as
    // padded rows
    bf16* dst = C::kWgmma
                    ? Bs + ((r >> 3) * (C::BN / 64) + (c >> 6)) * 512 +
                          (r & 7) * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3)
                    : Bs + r * C::kPB + c;
    cp_async16(dst, in ? w + (long long)(k0 + r) * N + n0 + c : w, in);
  }
}

// d += a * b, one m16n8k16 bf16 product into an f32 fragment. Unlike
// prefill::mma_bf16 not volatile: it reads and writes registers only, so
// the compiler may interleave independent products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------ wgmma (Compute tiles)
// The warpgroup's d (64 x 128, f32; this thread's 64) = a (each warp its
// 16 x 16 A fragment, rows 16 w .., the mma.sync layout) x B (16 x 128
// bf16 in shared memory, N contiguous, described by desc) + (accumulate ?
// d : 0). Asynchronous: wgmma_commit / wgmma_wait finish it.
__device__ __forceinline__ void wgmma_128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of the generic proxy (cp.async) seen by wgmma's
// reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor of B (N contiguous) in the 128-byte
// swizzle: atoms of 8 k rows x 64 columns (128 bytes a row, 1024 bytes,
// 1024-byte aligned), the 16-byte chunk j of row r stored at chunk j ^ r;
// lbo is the byte step between atoms along N, sbo along K.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

// acc += x_tile @ w_tile over this warp's k16 steps of one ring stage
// (kK of them), for its kWM x kWN. The stage's products for each (m16,
// n8) tile go into a fresh fragment, added to acc in f32: the tensor
// cores' running sum over 3 K / 16 products drifted ~17 times as far from
// the float64 product as cuBLAS's f32 product (1.9e-6 against 1.1e-7 of
// the largest sum of |x| |w| at K 3584), the f32 additions of the fresh
// sums come out nearer than cuBLAS's. The fresh fragments of kChainN
// column tiles (times kMT row tiles) take each product in turn, so that
// consecutive products are independent.
template <class C>
__device__ __forceinline__ void tile_product(
    float (&acc)[C::kMT][C::kNT][4], const float* As, const bf16* Bs,
    int wm, int wn, int wk, int lane) {
  constexpr int kChainN = C::kChainN, kK = C::BK / 16 / C::kWarpsK;
  if constexpr (C::kWgmma) {
    // this warp's 16 rows, split; the stage's 3 kK products into one fresh
    // accumulator, added to acc once they are done
    const float* a0 = As + (wm * 16 + (lane >> 2)) * C::kPA + 2 * (lane & 3);
    uint32_t a[kK][3][4];
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(
            a0 + 16 * kk + (r & 1) * 8 * C::kPA + (r >> 1) * 8);
        split3(v.x, v.y, a[kk][0][r], a[kk][1][r], a[kk][2][r]);
      }
    float f[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
#pragma unroll
      for (int part = 2; part >= 0; --part)       // the small parts first
        wgmma_128(f, a[kk][part],
                  smem_desc(Bs + 2 * kk * (C::BN / 64) * 512, 1024,
                            C::BN / 64 * 1024),
                  kk > 0 || part < 2);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] += f[4 * j + e];
    return;
  }
  const float* a0 = As + (wm * C::kWM + (lane >> 2)) * C::kPA + 2 * (lane & 3);
  const bf16* b0 = Bs + (((lane >> 3) & 1) * 8 + (lane & 7)) * C::kPB +
                   wn * C::kWN + (lane >> 4) * 8;
  // the A fragments (rows g, g + 8; columns 2t, 2t + 1 and 8 on) of the
  // warp's k16 steps, split
  uint32_t a[kK][C::kMT][3][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const int ks = kk * C::kWarpsK + wk;
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
      const float* p = a0 + mt * 16 * C::kPA + 16 * ks;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(
            p + (r & 1) * 8 * C::kPA + (r >> 1) * 8);
        split3(v.x, v.y, a[kk][mt][0][r], a[kk][mt][1][r], a[kk][mt][2][r]);
      }
    }
  }
#pragma unroll
  for (int n0 = 0; n0 < C::kNT; n0 += kChainN) {
    uint32_t b[kK][kChainN / 2][4];
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
#pragma unroll
      for (int np = 0; np < kChainN / 2; ++np)
        ldmatrix_x4_trans(b[kk][np], b0 + 16 * (kk * C::kWarpsK + wk) *
                                              C::kPB + 8 * n0 + 16 * np);
    float f[C::kMT][kChainN][4];
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kChainN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
#pragma unroll
      for (int part = 2; part >= 0; --part)       // the small parts first
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
          for (int j = 0; j < kChainN; ++j)
            mma(f[mt][j], a[kk][mt][part], b[kk][j / 2][2 * (j & 1)],
                b[kk][j / 2][2 * (j & 1) + 1]);
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kChainN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n0 + j][e] += f[mt][j][e];
  }
}

// The origin (m0, n0) of output tile `tile`: row tiles in groups of
// kGroupM, column-major inside a group, so that the tiles a wave works on
// share their x rows and w columns in L2.
template <class C>
__device__ __forceinline__ void tile_origin(int tile, int M, int N, int& m0,
                                            int& n0) {
  const int m_tiles = (M + C::BM - 1) / C::BM;
  const int n_tiles = (N + C::BN - 1) / C::BN;
  const int per_group = kGroupM * n_tiles;
  const int first = tile / per_group * kGroupM;
  const int in_group = tile % per_group;
  const int rows = min(m_tiles - first, kGroupM);
  m0 = (first + in_group % rows) * C::BM;
  n0 = in_group / rows * C::BN;
}

// acc = x[m0:, k tiles k_lo..k_hi) @ w[.., n0:] for this warp's share:
// the ring of cp.async stages, then the k-split warps' sums added into
// those of warp group 0 (the owners). Every thread calls it; the ring is
// free when it returns.
template <class C>
__device__ __forceinline__ void segment_product(
    float (&acc)[C::kMT][C::kNT][4], unsigned char* smem,
    const float* __restrict__ x, const bf16* __restrict__ w, int M, int N,
    int K, int m0, int n0, int k_lo, int k_hi, int tid, int wm, int wn,
    int wk, int lane) {
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  auto As = [&](int s) {
    return reinterpret_cast<float*>(smem + s * C::kStride);
  };
  auto Bs = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * C::kStride + C::kABytes);
  };
  const int nk = k_hi - k_lo;
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nk)
      load_tile<C>(As(s), Bs(s), x, w, M, N, K, m0, n0, (k_lo + s) * C::BK,
                   tid);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<C::kStages - 2>();
    if constexpr (C::kWgmma) fence_proxy_async();
    __syncthreads();                 // tile i landed; stage i - 1 is free
    const int nxt = i + C::kStages - 1;
    if (nxt < nk)
      load_tile<C>(As(nxt % C::kStages), Bs(nxt % C::kStages), x, w, M, N,
                   K, m0, n0, (k_lo + nxt) * C::BK, tid);
    cp_async_commit();
    tile_product<C>(acc, As(i % C::kStages), Bs(i % C::kStages), wm, wn, wk,
                    lane);
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is no longer read
  if constexpr (C::kWarpsK > 1) {
    // the k-split warps' sums into warp group 0's, in warp order
    constexpr int kRegs = C::kMT * C::kNT * 4;
    constexpr int kGroupThreads = C::kWarpsM * C::kWarpsN * 32;
    float* red = reinterpret_cast<float*>(smem);
    const int gt = tid % kGroupThreads;
    if (wk > 0) {
#pragma unroll
      for (int i = 0; i < C::kMT; ++i)
#pragma unroll
        for (int j = 0; j < C::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[((wk - 1) * kRegs + (i * C::kNT + j) * 4 + e) *
                    kGroupThreads + gt] = acc[i][j][e];
    }
    __syncthreads();
    if (wk == 0) {
      for (int q = 0; q < C::kWarpsK - 1; ++q)
#pragma unroll
        for (int i = 0; i < C::kMT; ++i)
#pragma unroll
          for (int j = 0; j < C::kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] +=
                  red[(q * kRegs + (i * C::kNT + j) * 4 + e) *
                          kGroupThreads + gt];
    }
    __syncthreads();                 // the sums are read
  }
}

// The work is the (output tile, k tile) pairs in tile order, k inner; block
// b takes pairs [b * per, (b + 1) * per): one whole tile when per is the k
// tiles a tile has, or a balanced share of the pairs (stream-K) when the
// tiles alone would leave the card's blocks idle. A segment of a block's
// range that covers a whole tile writes it; a segment that covers part of
// one writes an f32 partial (slot 0: the block's first segment, 1: its
// last), and the last of the tile's blocks to take tickets[tile] adds the
// partials in block order (so in k order: no float atomics, two calls give
// the same bits), writes the tile and resets the ticket to 0.
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
    mixed_matmul_kernel(const float* __restrict__ x,
                        const bf16* __restrict__ w, float* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ tickets,
                        int M, int N, int K, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  unsigned char* smem =
      smem_raw + (C::kAlign - smem_addr(smem_raw) % C::kAlign) % C::kAlign;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % C::kWarpsN;
  const int wm = warp / C::kWarpsN % C::kWarpsM;
  const int wk = warp / (C::kWarpsN * C::kWarpsM);
  const bool owner = wk == 0;        // holds a segment's sums
  constexpr int kTile = C::BM * C::BN;
  // lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each
  // m16 x n8 tile
  const int r0 = wm * C::kWM + (lane >> 2), c0 = wn * C::kWN + 2 * (lane & 3);

  const int KT = (K + C::BK - 1) / C::BK;
  const long long total = (long long)((M + C::BM - 1) / C::BM) *
                          ((N + C::BN - 1) / C::BN) * KT;
  long long it = (long long)blockIdx.x * per;
  const long long end = min(total, it + per);
  for (int seg = 0; it < end; ++seg) {
    const int tile = (int)(it / KT);
    const int k_lo = (int)(it - (long long)tile * KT);
    const int k_hi = (int)min((long long)KT, end - (long long)tile * KT);
    it = (long long)tile * KT + k_hi;
    int m0, n0;
    tile_origin<C>(tile, M, N, m0, n0);
    float acc[C::kMT][C::kNT][4];
    segment_product<C>(acc, smem, x, w, M, N, K, m0, n0, k_lo, k_hi, tid,
                       wm, wn, wk, lane);

    if (k_lo == 0 && k_hi == KT) {   // the whole tile
      if (owner) {
#pragma unroll
        for (int i = 0; i < C::kMT; ++i)
#pragma unroll
          for (int j = 0; j < C::kNT; ++j) {
            const int c = n0 + c0 + 8 * j;
            if (c >= N) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m0 + r0 + 16 * i + 8 * h;
              if (r < M)
                *reinterpret_cast<float2*>(out + (long long)r * N + c) =
                    make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            }
          }
      }
      continue;
    }

    if (owner) {
      float* mine = part + ((long long)blockIdx.x * 2 + (seg > 0)) * kTile;
#pragma unroll
      for (int i = 0; i < C::kMT; ++i)
#pragma unroll
        for (int j = 0; j < C::kNT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                mine + (r0 + 16 * i + 8 * h) * C::BN + c0 + 8 * j) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
    // the blocks whose ranges meet this tile
    const long long t0 = (long long)tile * KT;
    const int b_first = (int)(t0 / per);
    const int b_last = (int)((min(total, t0 + KT) - 1) / per);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(&tickets[tile], 1) == b_last - b_first;
      if (last) tickets[tile] = 0;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      // the partials in block order, 4 float4s a thread at a time so that
      // their loads are in flight together
      constexpr int kVec = kTile / 4;
      for (int v0 = tid; v0 < kVec; v0 += 4 * C::kThreads) {
        float4 sum[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int b = b_first; b <= b_last; ++b) {
          // block b's segment of this tile is its first one (slot 0) when
          // its range starts inside the tile
          const float4* pb = reinterpret_cast<const float4*>(
              part + ((long long)b * 2 + ((long long)b * per < t0)) * kTile);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int v = v0 + j * C::kThreads;
            if (v < kVec) {
              const float4 p = __ldcg(pb + v);
              sum[j].x += p.x;
              sum[j].y += p.y;
              sum[j].z += p.z;
              sum[j].w += p.w;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = v0 + j * C::kThreads;
          const int r = m0 + 4 * v / C::BN, c = n0 + 4 * v % C::BN;
          if (v < kVec && r < M && c < N)
            *reinterpret_cast<float4*>(out + (long long)r * N + c) = sum[j];
        }
      }
    }
    __syncthreads();                 // `last` is read
  }
}

// The fewest k tiles a block of a balanced split (stream-K) takes.
constexpr long long kMinKTiles = 4;

// The launch of an [M, K] x [K, N] product in the tiles C on a card of
// sms SMs. The work is the (output tile, k tile) pairs; each block takes
// `per` of them in order. A block takes a whole tile (per = the k tiles
// of one) where the tiles fill the blocks the card holds at once
// (kMinBlocks an SM) and whole_tiles holds; otherwise the blocks share
// the pairs evenly (stream-K), at least kMinKTiles a block.
struct Plan {
  long long per, blocks, tiles, kt;
  bool split() const { return per % kt != 0; }
};

template <class C>
Plan plan_of(int M, int N, int K, int sms, bool whole_tiles) {
  Plan p;
  p.kt = (K + C::BK - 1) / C::BK;
  p.tiles = (long long)((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
  const long long slots = (long long)sms * C::kMinBlocks;
  if (whole_tiles && p.tiles >= slots) {
    p.per = p.kt;
  } else {
    p.per = (p.tiles * p.kt + slots - 1) / slots;
    if (p.per < (p.kt < kMinKTiles ? p.kt : kMinKTiles))
      p.per = p.kt < kMinKTiles ? p.kt : kMinKTiles;
  }
  p.blocks = (p.tiles * p.kt + p.per - 1) / p.per;
  return p;
}

// static: each library's own `sized` (a template's static local would be
// one symbol across every library a process loads)
template <class C>
static int launch(const float* x, const bf16* w, float* out, float* part,
                  int* tickets, int M, int N, int K, const Plan& p,
                  cudaStream_t st) {
  if (p.tiles > 0x7fffffffLL || p.blocks > 0x7fffffffLL ||
      (p.split() && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int per = (int)p.per, blocks = (int)p.blocks;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        mixed_matmul_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  mixed_matmul_kernel<C><<<(unsigned)blocks, C::kThreads, C::kSmem, st>>>(
      x, w, out, part, tickets, M, N, K, per);
  return (int)cudaGetLastError();
}

}  // namespace mixed

// The plan of an [M, K] x [K, N] product on a card of sms SMs, for the
// caller's allocation: scratch[0] the floats of the f32 partials and
// scratch[1] the int tickets (zeroed, and left zero by every launch) that
// mixed_matmul_launch needs, both 0 where each block takes whole tiles.
// M <= 16 (a decode step's rows) runs the Stream tiles, more rows the
// Compute tiles.
namespace mixed {
static Plan plan(int M, int N, int K, int sms) {
  return M <= Stream::BM ? plan_of<Stream>(M, N, K, sms, false)
                         : plan_of<Compute>(M, N, K, sms, true);
}
}  // namespace mixed

extern "C" int mixed_matmul_plan(int M, int N, int K, int sms,
                                 long long* scratch) {
  if (M < 0 || N <= 0 || K <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const mixed::Plan p = mixed::plan(M > 0 ? M : 1, N, K, sms);
  const long long bm = M <= mixed::Stream::BM ? mixed::Stream::BM
                                               : mixed::Compute::BM;
  const long long bn = M <= mixed::Stream::BM ? mixed::Stream::BN
                                               : mixed::Compute::BN;
  scratch[0] = p.split() ? 2 * p.blocks * bm * bn : 0;
  scratch[1] = p.split() ? p.tiles : 0;
  return 0;
}

// x f32 [M, K], w bf16 [K, N], out f32 [M, N], all row-major, contiguous and
// 16-byte aligned; K and N multiples of 8; sms the card's SMs; part and
// tickets as mixed_matmul_plan sizes them (null where it gives 0).
extern "C" int mixed_matmul_launch(const void* x, const void* w, void* out,
                                   float* part, int* tickets, int M, int N,
                                   int K, int sms, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* of = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  const mixed::Plan p = mixed::plan(M, N, K, sms);
  if (M <= mixed::Stream::BM)
    return mixed::launch<mixed::Stream>(xf, wb, of, part, tickets, M, N, K,
                                        p, st);
  return mixed::launch<mixed::Compute>(xf, wb, of, part, tickets, M, N, K,
                                       p, st);
}
