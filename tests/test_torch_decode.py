"""The dense decode attention of the port: ``kernels.ref.flash_decode_ref``
(the CPU path of ``ops.flash_decode``) against the JAX package's
``flash_decode`` — its plain reference and its Pallas kernel in interpret
mode — and, on a card, the Hopper kernel ``csrc/flash_decode.cu`` against
both its plain version and the paged decode kernel.

The JAX function takes one sequence whose query sits after all of its
keys; the port's takes a batch with a per-sequence ``kv_len``, so each
sequence b is compared on its first ``kv_len[b]`` rows. JAX's window 0
means no window; the port passes the layer window (here ``Sk``) instead.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=2e-5)   # f32 sums in another order


def _inputs(seed, B, H, KV, Sk, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(dtype)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(dtype)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(dtype)
    return q, k, v


def _jax_one(q, k, v, kl, window, use_kernel):
    """JAX ``flash_decode`` on one sequence's first ``kl`` rows."""
    out = jops.flash_decode(jnp.asarray(q[:, None]),
                            jnp.asarray(k[:kl].transpose(1, 0, 2)),
                            jnp.asarray(v[:kl].transpose(1, 0, 2)),
                            window=window, block_k=128,
                            use_kernel=use_kernel)
    return np.asarray(out)[:, 0]


CASES = [  # H, KV, hd: G = 5 (Hymba's ratio) at hd 32 and 64, G = 4
    (10, 2, 32),
    (5, 1, 64),
    (8, 2, 32),
]


@pytest.mark.parametrize("H,KV,hd", CASES)
@pytest.mark.parametrize("window", [0, 17, 100])
def test_flash_decode_ref_matches_jax_ref(H, KV, hd, window):
    """Ragged kv_len (1, a partial tile, the full cache, mid-cache); a
    window of 17 binds for every sequence longer than 17, 100 only for
    the longer ones, 0 (none) never."""
    B, Sk = 4, 300
    q, k, v = _inputs(0, B, H, KV, Sk, hd)
    kv_len = np.array([1, 45, Sk, 170], np.int32)
    got = ref.flash_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(kv_len),
                               window or Sk).numpy()
    for b in range(B):
        want = _jax_one(q[b], k[b], v[b], kv_len[b], window, False)
        np.testing.assert_allclose(got[b], want, **F32_TOL)


@pytest.mark.parametrize("H,KV,hd", CASES[:2])
@pytest.mark.parametrize("window", [0, 40])
def test_flash_decode_ref_matches_pallas_kernel(H, KV, hd, window):
    """The Pallas ``flash_decode_kernel`` in interpret mode (ragged Sk
    padded to its tile by the JAX wrapper)."""
    B, Sk = 2, 150
    q, k, v = _inputs(1, B, H, KV, Sk, hd)
    kv_len = np.array([150, 77], np.int32)
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(kv_len),
                           window or Sk).numpy()
    for b in range(B):
        want = _jax_one(q[b], k[b], v[b], kv_len[b], window, True)
        np.testing.assert_allclose(got[b], want, **F32_TOL)


def test_window_of_one_attends_to_the_query_row_only():
    q, k, v = _inputs(2, 3, 4, 2, 64, 32)
    kv_len = torch.tensor([1, 20, 64], dtype=torch.int32)
    out = ref.flash_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), kv_len, 1)
    last = torch.from_numpy(v)[torch.arange(3), kv_len.long() - 1]
    torch.testing.assert_close(out, last.repeat_interleave(2, dim=1),
                               atol=0, rtol=0)


def test_dense_and_paged_plain_versions_are_bit_equal():
    """The CPU form of the paged == dense contract: the same rows under the
    same masks give the same bits, whatever page each row lives in."""
    B, H, KV, hd, bt, nbt = 3, 10, 2, 32, 32, 6
    q, k, v = _inputs(3, B, H, KV, nbt * bt, hd)
    kv_len = torch.tensor([5, 100, nbt * bt], dtype=torch.int32)
    perm = np.random.default_rng(3).permutation(B * nbt)
    pk = np.zeros((B * nbt, bt, KV, hd), np.float32)
    pv = np.zeros_like(pk)
    pk[perm] = k.reshape(B * nbt, bt, KV, hd)
    pv[perm] = v.reshape(B * nbt, bt, KV, hd)
    pidx = torch.from_numpy(perm.reshape(B, nbt).astype(np.int32))
    dense = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), kv_len, nbt * bt)
    paged = ops.flash_decode_paged(torch.from_numpy(q), torch.from_numpy(pk),
                                   torch.from_numpy(pv), pidx, kv_len)
    assert torch.equal(dense, paged)


def test_cpu_call_counts_a_plain_call_and_no_launch():
    ops.reset_launches()
    q, k, v = _inputs(4, 1, 4, 2, 32, 32)
    kv_len = torch.tensor([32], dtype=torch.int32)
    ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), kv_len, 32)
    assert ops.PLAIN_CALLS["flash_decode"] == 1
    assert ops.LAUNCHES["flash_decode"] == 0


# ------------------------------------------------ the kernels' split plan
# Both decode kernels cut each (KV head, sequence) pair's tiles into
# splits of DECODE_SPLIT_TILES 32-row tiles, one block each, and merge the
# splits' partials in split order. The plan (S and the scratch) is host
# code; the rule is pinned here in plain torch at the smoke shapes.
T_SPLIT = ops.DECODE_SPLIT_TILES
SPLIT_LENS = [1, 31, 32, 33, 32 * T_SPLIT - 1, 32 * T_SPLIT,
              32 * T_SPLIT + 1, 288]


def test_split_tiles_equal_the_kernel_constant():
    """The kernels take their tiles per split from the build, which
    passes DECODE_SPLIT_TILES; the header holds no number of its own."""
    from repro_torch.kernels import build

    assert f"-DDECODE_SPLIT_TILES={T_SPLIT}" in build.flags()
    src = (Path(ops.__file__).parent / "csrc" / "decode_attn.cuh").read_text()
    assert re.search(r"constexpr int kSplitTiles = DECODE_SPLIT_TILES;", src)


@pytest.mark.parametrize("rows", [1, 31, 32, 33, 63, 64, 65, 545, 576, 1536])
def test_split_plan_covers_the_longest_sequence(rows):
    """S splits of T tiles cover every tile of a sequence of ``rows``
    rows, with no split wholly past it; one partial of G * (hd + 2)
    floats per (pair, split)."""
    n_tiles = -(-rows // 32)
    S, shape = ops.decode_split_plan(n_tiles, B=8, KV=4, G=7, hd=128)
    assert S * T_SPLIT * 32 >= rows > (S - 1) * T_SPLIT * 32
    assert shape == (8 * 4 * S, 7 * 130)


@pytest.mark.parametrize("nbt,Tp", [(18, 0), (7, 32), (3, 40), (1, 1),
                                    (0, 64)])
def test_split_plan_is_the_same_for_dense_and_paged_rows(nbt, Tp):
    """nbt pages then a tail of Tp rows hold the rows of a dense cache of
    Sk = nbt * 32 + Tp rows, tile for tile: the same plan."""
    dense = ops.decode_split_plan(-(-(nbt * 32 + Tp) // 32), 3, 2, 5, 64)
    paged = ops.decode_split_plan(nbt + -(-Tp // 32), 3, 2, 5, 64)
    assert dense == paged


def _split_merge(q, k, v, allowed, t_begin, t_end, S):
    """The kernels' algorithm in plain torch: q [B, H, hd]; k/v
    [B, R, KV, hd] with R a multiple of 32 (the tiles' rows); allowed
    [B, R]; sequence b visits tiles [t_begin[b], t_end[b]). Split s of
    the S in the grid walks T_SPLIT tiles from t_begin + s * T_SPLIT
    (none past t_end), masks to -2^30 and keeps (m, l, acc); the splits
    merge in order."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    out = torch.zeros(B, KV, G, hd)
    for b in range(B):
        parts = []
        for s in range(S):
            t0 = t_begin[b] + s * T_SPLIT
            t1 = min(t0 + T_SPLIT, t_end[b])
            if t1 <= t0:
                continue
            rows = slice(t0 * 32, t1 * 32)
            qg = q[b].reshape(KV, G, hd)
            sc = torch.einsum("kgd,jkd->kgj", qg, k[b, rows]) * scale
            sc = torch.where(allowed[b, rows], sc, torch.tensor(-2.0 ** 30))
            m = sc.max(-1).values
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgj,jkd->kgd", p, v[b, rows])))
        assert len(parts) == -(-(t_end[b] - t_begin[b]) // T_SPLIT) \
            if t_end[b] > t_begin[b] else not parts
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).max(0).values
        w = [torch.exp(m - M) for m, _, _ in parts]
        lsum = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        num = sum(wi[..., None] * ai for wi, (_, _, ai) in zip(w, parts))
        out[b] = num / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(B, H, hd)


@pytest.mark.parametrize("H,KV,hd", [(8, 2, 32), (4, 2, 32)])   # smoke
@pytest.mark.parametrize("window", [288, 64, 40])
def test_split_merge_equals_dense_plain_version(H, KV, hd, window):
    """Dense rows: kv_len at every split edge, splits past the length in
    the grid, and windows whose first allowed row falls inside a split
    (t_begin > 0)."""
    Sk = 288
    B = len(SPLIT_LENS)
    q, k, v = (torch.from_numpy(x) for x in _inputs(7, B, H, KV, Sk, hd))
    kv_len = torch.tensor(SPLIT_LENS, dtype=torch.int32)
    S, _ = ops.decode_split_plan(-(-Sk // 32), B, KV, H // KV, hd)
    cols = torch.arange(Sk)
    kl = kv_len.long()[:, None]
    allowed = (cols < kl) & (kl - 1 - cols < window)
    lo = torch.clamp(kv_len.long() - window, min=0)
    t_begin = (lo // 32).tolist()
    t_end = ((kv_len.long() + 31) // 32).tolist()
    got = _split_merge(q, k, v, allowed, t_begin, t_end, S)
    want = ref.flash_decode_ref(q, k, v, kv_len, window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("tail_len", [None, 0, 1, 40, 64])
def test_split_merge_equals_paged_plain_version(tail_len):
    """Pages then a tail: spans at every split edge (page counts odd and
    even, so a tail crosses a split boundary), tails of 0 rows given,
    and rows past the tail's storage zero-filled as the kernel stages
    them. The kernel's 32-row tiles cover positions: the row at position
    c < span is its page's slot, the row at c >= span tail row c - span
    (``tests/test_torch_pages.py`` walks the same tiles at other page
    sizes)."""
    H, KV, hd, bt, nbt, Tp = 8, 2, 32, 32, 9, 64
    B = len(SPLIT_LENS)
    r = np.random.default_rng(8)
    P = B * nbt + 3
    q = torch.from_numpy(r.standard_normal((B, H, hd)).astype(np.float32))
    pk, pv = (torch.from_numpy(r.standard_normal((P, bt, KV, hd))
                               .astype(np.float32)) for _ in range(2))
    tk, tv = (torch.from_numpy(r.standard_normal((B, Tp, KV, hd))
                               .astype(np.float32)) for _ in range(2))
    pidx = torch.from_numpy(r.permutation(P)[: B * nbt].reshape(B, nbt)
                            .astype(np.int32))
    span = torch.tensor(SPLIT_LENS, dtype=torch.int32)
    tails = () if tail_len is None else (tk, tv, tail_len)
    Tpk = 0 if tail_len is None else Tp
    S, _ = ops.decode_split_plan(-(-(nbt * bt + Tpk) // 32), B, KV, H // KV,
                                 hd)
    # the tiles as the kernel sees them: position c from its page below
    # the span, then from the tail, zero past both
    R = -(-(nbt * bt + Tpk) // 32) * 32
    k = torch.zeros(B, R, KV, hd)
    v = torch.zeros(B, R, KV, hd)
    allowed = torch.zeros(B, R, dtype=torch.bool)
    t_end = []
    for b in range(B):
        n = int(span[b])
        k[b, :n] = pk[pidx[b].long()].reshape(nbt * bt, KV, hd)[:n]
        v[b, :n] = pv[pidx[b].long()].reshape(nbt * bt, KV, hd)[:n]
        tl = 0 if tail_len is None else tail_len
        k[b, n: n + Tpk] = tk[b, :Tpk]
        v[b, n: n + Tpk] = tv[b, :Tpk]
        allowed[b, : n + tl] = True
        t_end.append(-(-(n + tl) // 32))
    got = _split_merge(q, k, v, allowed, [0] * B, t_end, S)
    want = ref.flash_decode_paged_ref(q, pk, pv, pidx, span, *tails)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------------- on a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(a, b, dtype):
    # f32: summation order; bf16: one or two ulps of rounding one f32 value
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


GPU_CASES = [(25, 5, 64), (28, 4, 128), (10, 2, 32),
             # past 8 query heads a KV head (chunks of 8 over one ring):
             # Mistral-Large-2's G 12, Llama-3.1-405B's 16, Falcon-180B's 29;
             # and head dims 80 (Phi-2), 96 (Phi-3) and 112 (MPT-30B)
             (24, 2, 128), (32, 2, 128), (58, 2, 64), (16, 2, 80),
             (32, 1, 96), (16, 2, 112)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd", GPU_CASES)
@pytest.mark.parametrize("window", [1024, 1536])
@pytest.mark.parametrize("Sk", [1536, 1500])
def test_gpu_flash_decode(cuda, dtype, H, KV, hd, window, Sk):
    """Window 1024 binds for the long sequences; ragged kv_len; Sk 1500
    is no multiple of the 32-row tile (the last tile's rows past the
    cache are masked)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B = 4
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([1, 700, 1100, Sk], device=cuda, dtype=torch.int32)
    ops.reset_launches()
    got = ops.flash_decode(q, k, v, kv_len, window)
    assert ops.LAUNCHES["flash_decode"] == 1
    _close(got, ref.flash_decode_ref(q, k, v, kv_len, window), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd", GPU_CASES)
def test_gpu_flash_decode_equals_paged_kernel(cuda, dtype, H, KV, hd):
    """The same rows through the dense and the paged kernel: bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(6)
    B, nbt, bt = 3, 18, 32
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, nbt * bt, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, nbt * bt, KV, hd, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([33, 300, nbt * bt], device=cuda, dtype=torch.int32)
    perm = torch.randperm(B * nbt, generator=g, device=cuda)
    pk = torch.empty(B * nbt, bt, KV, hd, device=cuda, dtype=dtype)
    pv = torch.empty_like(pk)
    pk[perm] = k.reshape(B * nbt, bt, KV, hd)
    pv[perm] = v.reshape(B * nbt, bt, KV, hd)
    pidx = perm.reshape(B, nbt).to(torch.int32).contiguous()
    dense = ops.flash_decode(q, k, v, kv_len, nbt * bt)
    paged = ops.flash_decode_paged(q, pk, pv, pidx, kv_len)
    assert torch.equal(dense, paged)


@pytest.mark.gpu
def test_gpu_flash_decode_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 18, 64, device=cuda)
    k = torch.zeros(2, 64, 2, 64, device=cuda)
    kl = torch.full((2,), 64, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError):          # head dim 72: no instance
        ops.flash_decode(torch.zeros(2, 4, 72, device=cuda),
                         torch.zeros(2, 64, 2, 72, device=cuda),
                         torch.zeros(2, 64, 2, 72, device=cuda), kl, 64)
    with pytest.raises(ValueError):          # H not a multiple of KV
        ops.flash_decode(q[:, :5].contiguous(), k, k, kl, 64)
    with pytest.raises(TypeError):           # kv_len not int32
        ops.flash_decode(q[:, :4].contiguous(), k, k, kl.long(), 64)
    with pytest.raises(ValueError):          # a non-contiguous query
        ops.flash_decode(q[:, :4], k, k, kl, 64)
    # the kernels load K/V rows in 16-byte words
    kx = torch.zeros(k.numel() + 1, device=cuda)[1:].view(k.shape)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_decode(q[:, :4].contiguous(), kx, k, kl, 64)



def _as_pages(k, v, g):
    """The rows of a dense cache [B, nbt * 32, KV, hd] as shuffled 32-row
    pages of a pool, and their page table."""
    B, R, KV, hd = k.shape
    nbt = R // 32
    perm = torch.randperm(B * nbt, generator=g, device=k.device)
    pk = torch.empty(B * nbt, 32, KV, hd, device=k.device, dtype=k.dtype)
    pv = torch.empty_like(pk)
    pk[perm] = k.reshape(B * nbt, 32, KV, hd)
    pv[perm] = v.reshape(B * nbt, 32, KV, hd)
    return pk, pv, perm.reshape(B, nbt).to(torch.int32).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("G", [1, 5, 7, 8, 9, 16, 29])
@pytest.mark.parametrize("B", [1, 64])
def test_gpu_decode_split_edges(cuda, dtype, hd, G, B):
    """The split grid at its edges: kv_len 1, 31, 32, 33, T * 32 and
    T * 32 +- 1, and the full table (B 1 takes each alone, B 64 all at
    once). Each call is held to its plain version; the same rows through
    the paged kernel give the same bits; two calls give the same bits;
    a window whose first allowed row falls inside a split (t_begin > 0)
    is held to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(hd + G + B)
    KV, nbt = 2, 18
    H, Sk = G * KV, nbt * 32
    lens = SPLIT_LENS[:-1] + [Sk]
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    pk, pv, pidx = _as_pages(k, v, g)
    batches = ([[n] for n in lens] if B == 1 else
               [[lens[i % len(lens)] for i in range(B)]])
    for kl in batches:
        kv_len = torch.tensor(kl, device=cuda, dtype=torch.int32)
        ops.reset_launches()
        dense = ops.flash_decode(q, k, v, kv_len, Sk)
        assert ops.LAUNCHES["flash_decode"] == 1
        _close(dense, ref.flash_decode_ref(q, k, v, kv_len, Sk), dtype)
        assert torch.equal(ops.flash_decode(q, k, v, kv_len, Sk), dense)
        paged = ops.flash_decode_paged(q, pk, pv, pidx, kv_len)
        assert torch.equal(paged, dense), kl
        assert torch.equal(ops.flash_decode_paged(q, pk, pv, pidx, kv_len),
                           paged)
        for window in (100, 45):      # kv_len 576: first row 476 / 531
            got = ops.flash_decode(q, k, v, kv_len, window)
            _close(got, ref.flash_decode_ref(q, k, v, kv_len, window), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 96, 128])
@pytest.mark.parametrize("G", [1, 7, 16])
def test_gpu_decode_long_merge(cuda, dtype, hd, G):
    """Sequences of more than 32 splits, so the last split merges in more
    than one chunk of 32: kv_len 2049 (a chunk of one split), 4096 (two
    full chunks), 3001 and 1 in one batch, and a window of 2500 (kv_len
    4096: t_begin 49 > 0, and still 40 splits). Held to the plain version; the paged
    kernel over the same rows gives the same bits; two calls give the
    same bits."""
    g = torch.Generator(device=cuda).manual_seed(hd * G)
    KV, Sk = 2, 4096
    H = G * KV
    assert Sk // (32 * T_SPLIT) > 32
    q = torch.randn(4, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(4, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(4, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    pk, pv, pidx = _as_pages(k, v, g)
    kv_len = torch.tensor([2049, 4096, 3001, 1], device=cuda,
                          dtype=torch.int32)
    dense = ops.flash_decode(q, k, v, kv_len, Sk)
    _close(dense, ref.flash_decode_ref(q, k, v, kv_len, Sk), dtype)
    assert torch.equal(ops.flash_decode(q, k, v, kv_len, Sk), dense)
    paged = ops.flash_decode_paged(q, pk, pv, pidx, kv_len)
    assert torch.equal(paged, dense)
    assert torch.equal(ops.flash_decode_paged(q, pk, pv, pidx, kv_len),
                       paged)
    got = ops.flash_decode(q, k, v, kv_len, 2500)
    _close(got, ref.flash_decode_ref(q, k, v, kv_len, 2500), dtype)
    assert torch.equal(ops.flash_decode(q, k, v, kv_len, 2500), got)
