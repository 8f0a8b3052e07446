"""The port's kernels: their plain PyTorch versions against the JAX
package's references and Pallas kernels (interpret mode) on the CPU, and —
on a card — each CUDA kernel against its plain version
(``pytest -m gpu tests/test_torch_kernels.py``). The restore kernels'
plain versions are held against JAX in ``tests/test_torch_restore.py``."""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rope_align import rope_align_kernel
from repro.models.layers import gqa_attention
from repro.models.layers import rope_shift as jax_rope_shift
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import rope_shift

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------- rope_align
@pytest.mark.parametrize("S,KV,hd", [(64, 1, 32), (128, 2, 64), (96, 4, 128)])
def test_rope_align_plain_matches_jax(S, KV, hd):
    r = _rng(S + hd)
    k = r.normal(size=(S, KV, hd)).astype(np.float32)
    src = r.integers(0, 1000, S).astype(np.int32)
    tgt = r.integers(0, 1000, S).astype(np.int32)
    out = ops.rope_align(_t(k), _t(tgt - src), 1e6).numpy()
    exp = np.asarray(jref.rope_align_ref(jnp.asarray(k), jnp.asarray(src),
                                         jnp.asarray(tgt), 1e6))
    np.testing.assert_allclose(out, exp, atol=2e-5, rtol=0)
    # the Pallas kernel computes its frequencies as exp(-x ln θ): f32 ulps
    # of the angle at |delta| up to 1000 (the tests/test_kernels.py bound)
    pal = np.asarray(rope_align_kernel(jnp.asarray(k), jnp.asarray(src),
                                       jnp.asarray(tgt), 1e6,
                                       tile_s=32, interpret=True))
    np.testing.assert_allclose(out, pal, atol=3e-4, rtol=0)
    # the model's own re-rotation (layers.rope_shift) is the same function
    shifted = rope_shift(_t(k), _t(src), _t(tgt), 1e6).numpy()
    np.testing.assert_allclose(shifted, out, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        shifted, np.asarray(jax_rope_shift(jnp.asarray(k), jnp.asarray(src),
                                           jnp.asarray(tgt), 1e6)),
        atol=2e-5, rtol=0)


def test_rope_align_batched_rows_match_per_row():
    """One launch over [B, L, S] with per-request deltas [B, S] equals the
    JAX reference applied request by request, layer by layer."""
    r = _rng(3)
    B, L, S, KV, hd = 3, 2, 32, 2, 32
    k = r.normal(size=(B, L, S, KV, hd)).astype(np.float32)
    delta = r.integers(-300, 300, (B, S)).astype(np.int32)
    out = ops.rope_align(_t(k), _t(delta), 1e6).numpy()
    for b in range(B):
        for l in range(L):
            exp = jref.rope_delta_ref(jnp.asarray(k[b, l]),
                                      jnp.asarray(delta[b]), 1e6)
            np.testing.assert_allclose(out[b, l], np.asarray(exp), atol=2e-5,
                                       rtol=0)


# --------------------------------------------------------------- block_diff
@pytest.mark.parametrize("S", [96, 80])
def test_block_diff_plain_matches_pallas(S):
    """[N, nb] in one call == the Pallas kernel per (member, plane), max of
    the two planes, exactly (a ragged S pads with zero rows)."""
    r = _rng(S)
    N, L, KV, hd, bt, m = 4, 2, 2, 32, 32, 1
    ks = r.normal(size=(N, L, S, KV, hd)).astype(np.float32)
    vs = r.normal(size=(N, L, S, KV, hd)).astype(np.float32)
    ks[2] = ks[m]
    vs[2] = vs[m]
    ks[3, :, :32] = ks[m, :, :32]          # block 0 of member 3 clean in K
    vs[3, :, :32] = vs[m, :, :32]          # ... and in V
    out = ops.block_diff(_t(ks), _t(vs), m, bt).numpy()
    pad = (-S) % bt

    def jpad(x):
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, pad), (0, 0), (0, 0)))

    for n in range(N):
        dk = jops.block_diff(jpad(ks[m]), jpad(ks[n]), bt)
        dv = jops.block_diff(jpad(vs[m]), jpad(vs[n]), bt)
        np.testing.assert_array_equal(out[n], np.maximum(dk, dv))
    assert (out[m] == 0).all() and (out[2] == 0).all() and out[3, 0] == 0
    assert (out[3, 1:] > 0).all()


@pytest.mark.parametrize("where", ["mirror", "master"])
def test_block_diff_plain_propagates_nan_as_pallas(where):
    """A NaN in one block makes that block's value NaN, as the Pallas
    kernel's jnp.max gives: in one mirror's cell when a mirror holds it,
    in every member's cell when the Master does. Elsewhere exact."""
    r = _rng(7)
    N, L, S, KV, hd, bt, m = 3, 2, 64, 2, 32, 32, 1
    ks = r.normal(size=(N, L, S, KV, hd)).astype(np.float32)
    vs = r.normal(size=(N, L, S, KV, hd)).astype(np.float32)
    n = m if where == "master" else 2
    vs[n, 1, 5, 1, 3] = np.nan                 # block 0
    out = ops.block_diff(_t(ks), _t(vs), m, bt).numpy()
    for i in range(N):
        dk = jops.block_diff(jnp.asarray(ks[m]), jnp.asarray(ks[i]), bt)
        dv = jops.block_diff(jnp.asarray(vs[m]), jnp.asarray(vs[i]), bt)
        np.testing.assert_array_equal(out[i], np.maximum(dk, dv))
    want = np.zeros((N, 2), bool)
    want[:, 0] = where == "master"
    want[n, 0] = True
    np.testing.assert_array_equal(np.isnan(out), want)


# ----------------------------------------------------------- flash prefill
def _attn_inputs(seed, B=2, Sq=64, Sk=64, H=8, KV=2, hd=32):
    r = _rng(seed)
    q = r.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = r.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = r.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("selected", [False, True])
def test_flash_attention_plain_matches_gqa_attention(selected):
    """Plain version == the JAX engine's gqa_attention (f32, atol 2e-5),
    for full causal prefill (q_pos = arange) and for sorted selected
    query positions (the PIC selective layers)."""
    B, Sk, H, KV, hd = 2, 96, 8, 2, 32
    r = _rng(7)
    if selected:
        q_pos = np.sort(np.stack([r.choice(Sk, 40, replace=False)
                                  for _ in range(B)]), axis=1)
    else:
        q_pos = np.broadcast_to(np.arange(Sk), (B, Sk))
    q_pos = q_pos.astype(np.int32)
    q, k, v = _attn_inputs(11, B, q_pos.shape[1], Sk, H, KV, hd)
    out = ops.flash_attention(_t(q), _t(k), _t(v), q_pos=_t(q_pos),
                              window=Sk).numpy()
    kv_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    exp = gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                        window=Sk)
    np.testing.assert_allclose(out, np.asarray(exp), atol=2e-5, rtol=0)


def test_flash_attention_plain_matches_pallas_prefill():
    """With q_pos = arange and a ragged S, the plain version equals the
    Pallas flash prefill kernel in interpret mode (its [H, S, hd] layout,
    one batch row at a time)."""
    B, S, H, KV, hd = 2, 80, 8, 2, 32
    q, k, v = _attn_inputs(5, B, S, S, H, KV, hd)
    q_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    out = ops.flash_attention(_t(q), _t(k), _t(v), q_pos=_t(q_pos),
                              window=S).numpy()
    for b in range(B):
        pal = jops.flash_prefill(
            jnp.asarray(q[b].transpose(1, 0, 2)),
            jnp.asarray(k[b].transpose(1, 0, 2)),
            jnp.asarray(v[b].transpose(1, 0, 2)), block_q=32, block_k=32)
        np.testing.assert_allclose(out[b], np.asarray(pal).transpose(1, 0, 2),
                                   atol=2e-5, rtol=0)


def test_flash_attention_kv_len_masks_columns():
    """kv_len[b] hides columns at and past it, row by row."""
    B, S, H, KV, hd = 2, 64, 8, 2, 32
    q, k, v = _attn_inputs(9, B, S, S, H, KV, hd)
    q_pos = np.full((B, 4), S - 1, np.int32)
    kv_len = np.array([40, 64], np.int32)
    out = ops.flash_attention(_t(q[:, :4]), _t(k), _t(v), q_pos=_t(q_pos),
                              window=S, kv_len=_t(kv_len)).numpy()
    short = ops.flash_attention(_t(q[:1, :4]), _t(k[:1, :40]),
                                _t(v[:1, :40]), q_pos=_t(q_pos[:1]),
                                window=S).numpy()
    np.testing.assert_allclose(out[:1], short, atol=1e-6, rtol=0)


def _tf32(x):
    """f32 rounded to TF32 as the f32 prefill path's cvt.rna.tf32.f32
    rounds it: the bits plus 0x1000, masked with 0xFFFFE000."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, split):
    """a @ b on TF32 operands with f32 sums: one TF32 product, or the
    split (3xTF32) product of the kernel, hi = tf32(x), lo = tf32(x - hi),
    lo*hi + hi*lo, then + hi*hi (lo*lo dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _attention_tf32(q, k, v, q_pos, split):
    """Causal GQA attention with both products (Q K^T, then the
    unnormalised P times V) on TF32 operands, in f32 otherwise."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    allowed = q_pos[:, :, None].long() - torch.arange(Sk)[None, None] >= 0
    out = torch.empty_like(q)
    for b in range(B):
        for h in range(H):
            s = _mm_tf32(q[b, :, h], k[b, :, h // G].T, split) / hd ** 0.5
            s = torch.where(allowed[b], s, torch.tensor(-2.0 ** 30))
            p = torch.exp(s - s.max(-1, keepdim=True).values)
            out[b, :, h] = _mm_tf32(p, v[b, :, h // G], split) / p.sum(
                -1, keepdim=True)
    return out


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_split_tf32_products_hold_the_f32_tolerance(hd):
    """The numeric design of the f32 prefill path, in plain torch: at the
    recovery's selective shape cut to 2 sequences of 4 query heads over 1
    KV head (128 selected rows in blocks of 32, the last block always,
    over 544 columns), split-TF32 products stay within the card's f32
    tolerance of the plain version (atol 1e-4 + rtol 1e-4), and one TF32
    product a term does not."""
    r = _rng(hd)
    B, Sq, Sk, H, KV, bs = 2, 128, 544, 4, 1, 32
    last = Sk // bs - 1
    blocks = np.stack([np.sort(np.append(r.choice(last, Sq // bs - 1,
                                                  replace=False), last))
                       for _ in range(B)])
    q_pos = _t((blocks[:, :, None] * bs + np.arange(bs)).reshape(B, Sq)
               .astype(np.int32))
    q, k, v = (_t(x) for x in _attn_inputs(hd, B, Sq, Sk, H, KV, hd))
    want = ref.flash_attention_ref(q, k, v, q_pos=q_pos, window=Sk)

    def held(got):
        return bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())

    split = _attention_tf32(q, k, v, q_pos, split=True)
    assert held(split), (split - want).abs().max().item()
    assert (split - want).abs().max().item() < 1e-5
    assert not held(_attention_tf32(q, k, v, q_pos, split=False))


def _bwd_bf16_rounded(q, k, v, out, dout, q_pos, window, kv_len, softcap,
                      lo_term=True):
    """``ref.flash_attention_bwd_ref`` as the bf16 backward kernel rounds
    it: the products of bf16 q, k, v and dout in f32, P and dS (the scale
    folded into dS) rounded to bf16 hi + lo (hi = bf16(x), lo = bf16(x -
    hi); hi alone without ``lo_term``) before the three output products,
    each result rounded to bf16 once."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, 1.0 / hd ** 0.5

    def rounded(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if lo_term else hi

    qg = q.reshape(B, Sq, KV, G, hd).float()
    dog = dout.reshape(B, Sq, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    raw = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
    delta = q_pos[:, :, None].long() - torch.arange(Sk)[None, None]
    allowed = (delta >= 0) & (delta < window)
    if kv_len is not None:
        allowed &= torch.arange(Sk)[None, None] < kv_len[:, None, None].long()
    allowed = allowed[:, None, None]
    probs = torch.where(allowed, torch.softmax(torch.where(
        allowed, ref.cap_logits(raw, softcap), torch.tensor(-2.0 ** 30)),
        dim=-1), 0.0)
    dlt = (dog * out.reshape(B, Sq, KV, G, hd).float()).sum(-1)
    ds = probs * (torch.einsum("bqkgh,bskh->bkgqs", dog, vf)
                  - dlt.permute(0, 2, 3, 1)[..., None]) * scale
    if softcap:
        ds = ds * (1.0 - torch.tanh(raw / softcap).square())
    p, ds = rounded(probs), rounded(ds)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf).reshape(B, Sq, H, hd)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    return tuple(x.bfloat16() for x in (dq, dk, dv))


@pytest.mark.parametrize("case", ["causal", "softcap", "window_kv_len"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_bwd_bf16_rounding_policy_holds_the_bf16_tolerance(hd, G, case):
    """The numeric design of the bf16 attention backward, in plain torch:
    from bf16 q, k, v and dout (S 257, 2 KV heads; uncapped, a soft cap of
    30 with q x 8, or a binding window of 70 with a ragged kv_len), P and dS
    rounded to bf16 hi + lo before the three output products stay within
    the card's bf16 tolerance (atol 2e-2 + rtol 1.6e-2) of the f32 plain
    version on the same values. The error with hi alone is printed beside
    it: what the lo term buys."""
    r = _rng(hd * 10 + G)
    B, S, KV = 2, 257, 2
    H = KV * G
    window, kv_len, softcap, qs = S, None, 0.0, 1.0
    if case == "softcap":
        softcap, qs = 30.0, 8.0
    elif case == "window_kv_len":
        window, kv_len = 70, torch.tensor([257, 190], dtype=torch.int32)
    q, k, v = (_t(x).bfloat16() for x in _attn_inputs(
        hd * 10 + G, B, S, S, H, KV, hd))
    q = (q.float() * qs).bfloat16()
    dout = _t(r.normal(size=(B, S, H, hd)).astype(np.float32)).bfloat16()
    q_pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    kw = dict(q_pos=q_pos, window=window, kv_len=kv_len, softcap=softcap)
    out = ref.flash_attention_ref(q, k, v, **kw)
    want = ref.flash_attention_bwd_ref(
        *(x.float() for x in (q, k, v, out, dout)), **kw)
    got = _bwd_bf16_rounded(q, k, v, out, dout, **kw)
    hi_only = _bwd_bf16_rounded(q, k, v, out, dout, **kw, lo_term=False)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, hi_only):
        err = _held(a, b, torch.bfloat16,
                    f"bf16 policy {name} {case} hd {hd} G {G}")
        print(f"  hi alone: max abs err {(c.float() - b).abs().max():.3g} "
              f"(hi + lo {err:.3g})")


# ------------------------------------------------------- paged decode
def test_flash_decode_paged_plain_matches_jax():
    """Ragged per-sequence spans, a tail > 0 and GQA 8:2: each sequence
    equals the JAX paged-decode reference with its own span."""
    r = _rng(13)
    B, H, KV, hd, bt, P, nbt, Tp, T = 3, 8, 2, 32, 32, 24, 5, 64, 40
    q = r.normal(size=(B, H, hd)).astype(np.float32)
    pk = r.normal(size=(P, bt, KV, hd)).astype(np.float32)
    pv = r.normal(size=(P, bt, KV, hd)).astype(np.float32)
    page_idx = r.permutation(P)[: B * nbt].reshape(B, nbt).astype(np.int32)
    span = np.array([1, 70, nbt * bt], np.int32)
    tk = r.normal(size=(B, Tp, KV, hd)).astype(np.float32)
    tv = r.normal(size=(B, Tp, KV, hd)).astype(np.float32)
    for tail in (False, True):
        args = (_t(tk), _t(tv), T) if tail else ()
        out = ops.flash_decode_paged(_t(q), _t(pk), _t(pv), _t(page_idx),
                                     _t(span), *args).numpy()
        for b in range(B):
            nbh = -(-int(span[b]) // bt)
            exp = jref.flash_decode_paged_ref(
                jnp.asarray(q[b][:, None]), jnp.asarray(pk), jnp.asarray(pv),
                jnp.asarray(page_idx[b, :nbh]),
                jnp.asarray(tk[b, :T]) if tail else None,
                jnp.asarray(tv[b, :T]) if tail else None,
                span_len=int(span[b]))
            np.testing.assert_allclose(out[b], np.asarray(exp)[:, 0],
                                       atol=2e-5, rtol=0)


def _gathered(pk, pv, page_idx, span, tk, tv, tail_len):
    """Each sequence's valid rows in position order (pages, then the
    tail) as a dense cache, zero past them, and their count."""
    B, nbt = page_idx.shape
    P, bt, KV, hd = pk.shape
    Tp = tk.shape[1] if tk is not None else 0
    kd = torch.zeros(B, nbt * bt + Tp, KV, hd, dtype=pk.dtype)
    vd = torch.zeros_like(kd)
    for b in range(B):
        n = int(span[b])
        rows = page_idx[b].long()
        kd[b, :n] = pk[rows].reshape(-1, KV, hd)[:n]
        vd[b, :n] = pv[rows].reshape(-1, KV, hd)[:n]
        if tail_len:
            kd[b, n:n + tail_len] = tk[b, :tail_len]
            vd[b, n:n + tail_len] = tv[b, :tail_len]
    return kd, vd, (span + tail_len).to(torch.int32)


@pytest.mark.parametrize("window", [1, 31, 64, 100, 0])
@pytest.mark.parametrize("tail_len", [0, 40])
def test_flash_decode_paged_plain_window_matches_dense_on_gathered_rows(
        window, tail_len):
    """The windowed paged plain version against the dense one on the same
    rows gathered in position order (a page column c at c, a tail row t
    at ``span + t``, the query at ``span + tail_len - 1``), and against
    the JAX paged-decode reference with the same window, per sequence:
    ragged spans of 1, 70 and 160 rows, windows that bind on every
    sequence, on some, and not at all (0)."""
    r = _rng(17 + window)
    B, H, KV, hd, bt, P, nbt, Tp = 3, 8, 2, 32, 32, 24, 5, 64
    q = _t(r.normal(size=(B, H, hd)).astype(np.float32))
    pk, pv = (_t(r.normal(size=(P, bt, KV, hd)).astype(np.float32))
              for _ in range(2))
    page_idx = _t(r.permutation(P)[: B * nbt].reshape(B, nbt)
                  .astype(np.int32))
    span = _t(np.array([1, 70, nbt * bt], np.int32))
    tk, tv = (_t(r.normal(size=(B, Tp, KV, hd)).astype(np.float32))
              for _ in range(2))
    tail = (tk, tv, tail_len) if tail_len else ()
    got = ref.flash_decode_paged_ref(q, pk, pv, page_idx, span, *tail,
                                     window=window)
    kd, vd, kv_len = _gathered(pk, pv, page_idx, span, tk, tv, tail_len)
    want = ref.flash_decode_ref(q, kd, vd, kv_len, window or kd.shape[1])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    if window:       # the window changes the answer where it binds
        full = ref.flash_decode_paged_ref(q, pk, pv, page_idx, span, *tail)
        assert not torch.allclose(got[-1], full[-1], atol=1e-4)
    for b in range(B):
        nbh = -(-int(span[b]) // bt)
        exp = jref.flash_decode_paged_ref(
            jnp.asarray(q[b].numpy()[:, None]), jnp.asarray(pk.numpy()),
            jnp.asarray(pv.numpy()), jnp.asarray(page_idx[b, :nbh].numpy()),
            jnp.asarray(tk[b, :tail_len].numpy()) if tail_len else None,
            jnp.asarray(tv[b, :tail_len].numpy()) if tail_len else None,
            span_len=int(span[b]), window=window)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(exp)[:, 0],
                                   atol=2e-5, rtol=0)


# ----------------------------------------------------- dispatch contract
def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launches()
    k = torch.zeros(4, 1, 32)
    ops.rope_align(k, torch.zeros(4, dtype=torch.int32), 1e4)
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_unsupported_device_raises():
    k = torch.zeros(4, 1, 32, device="meta")
    with pytest.raises(ValueError):
        ops.rope_align(k, torch.zeros(4, dtype=torch.int32, device="meta"),
                       1e4)


# ------------------------------------------------------------- on a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, dtype):
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


GPU_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("hd", [32, 64, 80, 96, 112, 128, 256])
@pytest.mark.parametrize("lead,S,KV,D", [
    ((28,), 544, 4, 1),          # the shared blocks' call
    ((8, 28), 32, 4, 8),         # the decode tails' call
    ((4, 7), 160, 4, 4),         # 7 rows a delta
    ((3, 2), 37, 5, 3),          # odd S, 5 KV heads, 2 rows a delta
    ((6,), 1, 4, 2)])            # one token
def test_gpu_rope_align(cuda, dtype, hd, lead, S, KV, D):
    g = torch.Generator(device=cuda).manual_seed(hd + S)
    k = torch.randn(*lead, S, KV, hd, generator=g, device=cuda).to(dtype)
    d = torch.randint(-900, 900, (D, S), generator=g, device=cuda,
                      dtype=torch.int32)
    d = d[0] if D == 1 else d
    out = ops.rope_align(k, d, 1e6)
    _close(out, ref.rope_delta_ref(k, d, 1e6), dtype)
    assert torch.equal(out, ops.rope_align(k, d, 1e6))


def _family(cuda, dtype, N, L, S, KV, hd, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    ks = torch.randn(N, L, S, KV, hd, generator=g, device=cuda).to(dtype)
    vs = torch.randn(N, L, S, KV, hd, generator=g, device=cuda).to(dtype)
    return ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("N", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("L,S,KV,hd", [
    (3, 100, 4, 128),            # ragged last block
    (2, 20, 2, 64),              # S below one block
    (1, 544, 4, 128),            # one layer, the path's tokens
    (2, 70, 5, 32),              # 5 KV heads of 32
    (2, 100, 1, 80),             # Phi-2's head dim
    (2, 100, 2, 96),             # Phi-3's
    (2, 100, 2, 112)])           # MPT-30B's
def test_gpu_block_diff(cuda, dtype, N, L, S, KV, hd):
    """Bit-exact against the plain version for any family size (16 needs
    two chunks of members a thread), the Master mid-family, some members and
    blocks equal to the Master's; two calls bit-equal."""
    ks, vs = _family(cuda, dtype, N, L, S, KV, hd, N * S + hd)
    m = N // 2
    if N > 2:
        ks[0], vs[0] = ks[m], vs[m]
        ks[1, :, :32], vs[1, :, :32] = ks[m, :, :32], vs[m, :, :32]
    out = ops.block_diff(ks, vs, m, 32)
    want = ref.block_diff_ref(ks, vs, m, 32)
    assert torch.equal(out, want)
    assert torch.equal(out, ops.block_diff(ks, vs, m, 32))
    assert (out[m] == 0).all()
    if N > 1:
        assert (out[N - 1 if N > 2 else 0] > 0).all()
    if N > 2:
        assert (out[0] == 0).all() and out[1, 0] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("where", ["mirror", "master"])
def test_gpu_block_diff_propagates_nan(cuda, dtype, where):
    """A NaN in a block gives NaN in that block's cell (every member's
    when the Master holds it), as jnp.max and the plain version give;
    every other cell exactly the plain version's."""
    ks, vs = _family(cuda, dtype, 4, 3, 100, 4, 128, 5)
    n = 0 if where == "master" else 2
    vs[n, 1, 37, 2, 5] = float("nan")          # block 1
    out = ops.block_diff(ks, vs, 0, 32)
    want = ref.block_diff_ref(ks, vs, 0, 32)
    nan = torch.zeros_like(want, dtype=torch.bool)
    nan[:, 1] = where == "master"
    nan[n, 1] = True
    assert torch.equal(torch.isnan(want), nan)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], want[~nan])


@pytest.mark.gpu
def test_gpu_store_kernels_reject_unaligned_rows(cuda):
    """Both kernels move 16-byte words: an operand off 16 bytes raises."""
    flat = torch.randn(2 * 2 * 40 * 2 * 32 + 1, device=cuda)
    x = flat[1:].view(2, 2, 40, 2, 32)
    with pytest.raises(ValueError):
        ops.block_diff(x, x, 0, 32)
    with pytest.raises(ValueError):
        ops.rope_align(x[0], torch.zeros(40, dtype=torch.int32,
                                         device=cuda), 1e6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("H,KV,hd", [(28, 4, 128), (8, 2, 32), (25, 5, 64)])
def test_gpu_flash_attention(cuda, dtype, H, KV, hd):
    g = torch.Generator(device=cuda).manual_seed(2)
    B, S = 2, 150
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
    full = torch.arange(S, device=cuda, dtype=torch.int32).expand(B, S)
    sel = torch.sort(torch.randperm(S, generator=g, device=cuda)[:64]
                     ).values.to(torch.int32).expand(B, 64).contiguous()
    kv_len = torch.tensor([S, 100], device=cuda, dtype=torch.int32)
    for qq, qp, kl in ((q, full.contiguous(), None),
                       (q[:, :64].contiguous(), sel, kv_len)):
        # window 60 binds from position 60 on, and every selected row
        # keeps an allowed column below kv_len 100 (a row with none is
        # undefined: each version averages over the columns it visits)
        for w in (S, 60):
            _close(ops.flash_attention(qq, k, v, q_pos=qp, window=w,
                                       kv_len=kl),
                   ref.flash_attention_ref(qq, k, v, q_pos=qp, window=w,
                                           kv_len=kl), dtype)
    # the recovery's selective call: 128 selected rows in 4 blocks of 32
    # (the last block always) over 544 columns, as _select_blocks gives
    Sk, bs = 544, 32
    blocks = torch.stack([torch.cat([torch.sort(torch.randperm(
        Sk // bs - 1, generator=g, device=cuda)[:3]).values,
        torch.tensor([Sk // bs - 1], device=cuda)]) for _ in range(B)])
    sel = (blocks[:, :, None] * bs + torch.arange(bs, device=cuda)).reshape(
        B, 4 * bs).to(torch.int32).contiguous()
    q = torch.randn(B, 4 * bs, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    got = ops.flash_attention(q, k, v, q_pos=sel, window=Sk)
    assert torch.equal(ops.flash_attention(q, k, v, q_pos=sel, window=Sk),
                       got), "two calls differ"
    _close(got, ref.flash_attention_ref(q, k, v, q_pos=sel, window=Sk), dtype)
    # extend's call: the queries of a suffix at positions p..S-1 (Sq < Sk)
    # over a cache of 256 rows that holds S = 217, kv_len S; rows past S
    # hold large values that must not reach the output
    S, p, rows = 217, 100, 256
    pos = (p + torch.arange(S - p, device=cuda, dtype=torch.int32)).expand(
        B, S - p).contiguous()
    q = torch.randn(B, S - p, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, rows, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, rows, KV, hd, generator=g, device=cuda).to(dtype)
    k[:, S:], v[:, S:] = 300.0, -300.0
    kl = torch.full((B,), S, device=cuda, dtype=torch.int32)
    for w in (rows, 60):
        got = ops.flash_attention(q, k, v, q_pos=pos, window=w, kv_len=kl)
        assert torch.equal(ops.flash_attention(q, k, v, q_pos=pos, window=w,
                                               kv_len=kl), got), w
        _close(got, ref.flash_attention_ref(q, k, v, q_pos=pos, window=w,
                                            kv_len=kl), dtype)


def _held(got, want, dtype, what):
    """The card's tolerance against the plain version (f32 atol 1e-4 +
    rtol 1e-4; bf16 atol 2e-2 + rtol 1.6e-2, one or two bf16 ulps of the
    same f32 value); prints and returns the max abs error."""
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1.6e-2)
    err = (got.float() - want.float()).abs().max().item()
    print(f"{what} {dtype}: max abs err {err:.3g}")
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol, msg=lambda m: f"{what}: {m}")
    return err


def _shifted(x):
    """The same values one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16
    return y


# head dims x GQA groups of the tensor-core path's edge tests: the hd 32,
# 64 and 128 fragments, G 1 (H == KV), 5 (Hymba-1.5B), 7 (Qwen2.5-7B) and
# 8; hd 256 (two warps a row group, Q in shared memory in both types) at
# G 1, 2 (Gemma3-12B), 4 (Gemma3-1B) and 8
EDGE_HEADS = [(hd, G) for hd in (32, 64, 128) for G in (1, 5, 7, 8)] + \
    [(256, G) for G in (1, 2, 4, 8)] + \
    [(hd, G) for hd in (80, 96, 112) for G in (1, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("case", ["causal_ragged", "kv_len", "window",
                                  "selected", "unaligned"])
@pytest.mark.parametrize("hd,G", EDGE_HEADS)
def test_gpu_flash_prefill_edges(cuda, dtype, case, hd, G):
    """The dense prefill kernel where the tile function's 16-row
    fragments and KV tiles (64 rows in bf16, 32 in f32) are cut: Sq 141
    (= 2 x 64 + 13), kv_len 155 and 71, a binding window with a ragged
    kv_len, selected query positions with a binding window, and q, K and V
    off a 16-byte boundary (staged with plain loads: the same bits as the
    aligned launch). Two calls give the same bits. Every query row keeps
    an allowed column."""
    g = torch.Generator(device=cuda).manual_seed(hd + G)
    KV, B = 2, 2
    H = KV * G
    Sk, Sq, window, kv_len, q_pos = 141, 141, 141, None, None
    if case == "kv_len":
        Sk = Sq = 200
        kv_len = [155, 71]
    elif case == "window":
        Sk = Sq = 300
        window, kv_len = 100, [300, 251]
    elif case == "selected":
        Sk, Sq, window, kv_len = 250, 97, 90, [233, 250]
        q_pos = torch.stack([torch.sort(torch.randperm(
            Sk, generator=g, device=cuda)[:Sq]).values for _ in range(B)])
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    if q_pos is None:
        q_pos = torch.arange(Sq, device=cuda).expand(B, Sq)
    q_pos = q_pos.to(torch.int32).contiguous()
    kl = (None if kv_len is None else
          torch.tensor(kv_len, device=cuda, dtype=torch.int32))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, q_pos=q_pos, window=window, kv_len=kl)
    assert ops.LAUNCHES["flash_prefill"] == 1
    assert torch.equal(ops.flash_attention(q, k, v, q_pos=q_pos,
                                           window=window, kv_len=kl), got), \
        "two calls differ"
    if case == "unaligned":
        assert torch.equal(ops.flash_attention(
            _shifted(q), _shifted(k), _shifted(v), q_pos=q_pos,
            window=window, kv_len=kl), got)
    _held(got, ref.flash_attention_ref(q, k, v, q_pos=q_pos, window=window,
                                       kv_len=kl), dtype,
          f"flash_prefill {case} hd {hd} G {G}")


# head dims x G of the backward's edge tests: 32, 64, 128 and 256 at G 1,
# 5 and 8; 80 (Phi-2), 96 (Phi-3-mini) and 112 (MPT-30B), whose f32
# instances split the output columns over two warps in 40, 48 and 56
# columns (a last half step at 80 and 112), at G 1 and 4
BWD_HEADS = [(hd, G) for hd in (32, 64, 128, 256) for G in (1, 5, 8)] + \
    [(hd, G) for hd in (80, 96, 112) for G in (1, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("case", ["causal", "window_kv_len", "softcap",
                                  "selected", "unaligned"])
@pytest.mark.parametrize("hd,G", BWD_HEADS)
def test_gpu_flash_attention_bwd(cuda, dtype, case, hd, G):
    """The backward kernel (``ops.flash_attention_bwd``, one launch of its
    two kernels) against ``ref.flash_attention_bwd_ref``: dq, dk and dv
    where its 64-row blocks and its ring's 16-, 32- and 64-row tiles are
    cut (S 141), with a binding window and a ragged kv_len, a soft cap of
    30 (q scaled so the cap bends the logits), selected query positions
    over a longer KV with a window, and q, k, v, out and dout off a
    16-byte boundary (staged with plain loads: the same bits as the
    aligned call). Two calls give the same bits. Every query row keeps an
    allowed column."""
    g = torch.Generator(device=cuda).manual_seed(hd * G)
    KV, B = 2, 2
    H = KV * G
    Sq = Sk = 141
    window, kv_len, q_pos, cap, qs = 2 ** 31 - 1, None, None, 0.0, 1.0
    if case == "window_kv_len":
        Sq = Sk = 200
        window, kv_len = 70, [200, 151]
    elif case == "softcap":
        cap, qs = 30.0, 8.0
    elif case == "selected":
        Sk, Sq, window, kv_len = 250, 97, 90, [233, 250]
        q_pos = torch.stack([torch.sort(torch.randperm(
            Sk, generator=g, device=cuda)[:Sq]).values for _ in range(B)])
    q = (qs * torch.randn(B, Sq, H, hd, generator=g, device=cuda)).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    dout = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype)
    if q_pos is None:
        q_pos = torch.arange(Sq, device=cuda).expand(B, Sq)
    q_pos = q_pos.to(torch.int32).contiguous()
    kl = (None if kv_len is None else
          torch.tensor(kv_len, device=cuda, dtype=torch.int32))
    kw = dict(q_pos=q_pos, window=window, kv_len=kl, softcap=cap)
    out = ops.flash_attention(q, k, v, **kw)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, out, dout, **kw)
    assert ops.LAUNCHES["flash_prefill_bwd"] == 1
    again = ops.flash_attention_bwd(q, k, v, out, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "two calls differ"
    if case == "unaligned":
        moved = ops.flash_attention_bwd(*map(_shifted, (q, k, v, out, dout)),
                                        **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, moved)), \
            "unaligned operands change the bits"
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _held(a, b, dtype, f"flash_prefill_bwd {name} {case} hd {hd} G {G}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
def test_gpu_flash_attention_bwd_long_causal(cuda, dtype):
    """A long causal call (S 1024, hd 128, G 4): dq_kernel walks up to 32
    or more ring tiles a block and dkv_kernel up to 4 x 32 steps, so both
    rings wrap many times; held to the plain version, two calls bit-equal,
    one counted launch."""
    g = torch.Generator(device=cuda).manual_seed(1024)
    B, S, KV, G, hd = 1, 1024, 4, 4, 128
    q, dout = (torch.randn(B, S, KV * G, hd, generator=g, device=cuda)
               .to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kw = dict(q_pos=torch.arange(S, device=cuda, dtype=torch.int32)
              .expand(B, S).contiguous(), window=S)
    out = ops.flash_attention(q, k, v, **kw)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, out, dout, **kw)
    assert ops.LAUNCHES["flash_prefill_bwd"] == 1
    assert all(torch.equal(a, b) for a, b in zip(
        got, ops.flash_attention_bwd(q, k, v, out, dout, **kw)))
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _held(a, b, dtype, f"flash_prefill_bwd long causal {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("H,KV,hd", [(28, 4, 128), (8, 2, 32)])
def test_gpu_flash_decode_paged(cuda, dtype, H, KV, hd):
    g = torch.Generator(device=cuda).manual_seed(3)
    B, P, nbt = 4, 64, 10
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    pk = torch.randn(P, 32, KV, hd, generator=g, device=cuda).to(dtype)
    pv = torch.randn(P, 32, KV, hd, generator=g, device=cuda).to(dtype)
    pidx = torch.randperm(P, generator=g, device=cuda)[: B * nbt].reshape(
        B, nbt).to(torch.int32).contiguous()
    span = torch.tensor([1, 33, 200, 320], device=cuda, dtype=torch.int32)
    tk = torch.randn(B, 64, KV, hd, generator=g, device=cuda).to(dtype)
    tv = torch.randn(B, 64, KV, hd, generator=g, device=cuda).to(dtype)
    _close(ops.flash_decode_paged(q, pk, pv, pidx, span),
           ref.flash_decode_paged_ref(q, pk, pv, pidx, span), dtype)
    _close(ops.flash_decode_paged(q, pk, pv, pidx, span, tk, tv, 40),
           ref.flash_decode_paged_ref(q, pk, pv, pidx, span, tk, tv, 40),
           dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("hd", [32, 64, 80, 96, 112, 128, 256])
@pytest.mark.parametrize("G", [1, 5, 7, 8, 12, 16, 29])
@pytest.mark.parametrize("B", [1, 64])
def test_gpu_flash_decode_paged_split_tails(cuda, dtype, hd, G, B):
    """Pages then a tail, cut into splits of ops.DECODE_SPLIT_TILES tiles:
    spans of 1, 31, 32, 33, 2 and 3 pages (so the first tail tile shares
    a split with the last page, or starts one), tails of 0, 1, 33 and 64
    rows, and tails given with tail_len 0. Each call is held to its plain
    version and a second call gives the same bits; where the span is
    whole pages, the dense kernel over the same rows (pages, then the
    tail) gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(hd * G + B)
    KV, nbt, Tp = 2, 5, 64
    H = G * KV
    P = B * nbt + 7
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    pk = torch.randn(P, 32, KV, hd, generator=g, device=cuda).to(dtype)
    pv = torch.randn(P, 32, KV, hd, generator=g, device=cuda).to(dtype)
    tk = torch.randn(B, Tp, KV, hd, generator=g, device=cuda).to(dtype)
    tv = torch.randn(B, Tp, KV, hd, generator=g, device=cuda).to(dtype)
    pidx = torch.randperm(P, generator=g, device=cuda)[: B * nbt].reshape(
        B, nbt).to(torch.int32).contiguous()
    spans = [1, 31, 32, 33, 64, 96]
    for sp in ([[s] for s in spans] if B == 1 else
               [[spans[i % len(spans)] for i in range(B)]]):
        span = torch.tensor(sp, device=cuda, dtype=torch.int32)
        for tail_len in (0, 1, 33, 64):
            args = (q, pk, pv, pidx, span, tk, tv, tail_len)
            got = ops.flash_decode_paged(*args)
            _close(got, ref.flash_decode_paged_ref(*args), dtype)
            assert torch.equal(ops.flash_decode_paged(*args), got)
            if B == 1 and sp[0] % 32 == 0:
                n = sp[0] // 32
                rows = pidx[0, :n].long()
                kd = torch.cat([pk[rows].reshape(1, n * 32, KV, hd), tk], 1)
                vd = torch.cat([pv[rows].reshape(1, n * 32, KV, hd), tv], 1)
                kl = torch.tensor([n * 32 + tail_len], device=cuda,
                                  dtype=torch.int32)
                assert torch.equal(ops.flash_decode(q, kd.contiguous(),
                                                    vd.contiguous(), kl,
                                                    kd.shape[1]), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("hd", [32, 80, 96, 112, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_gpu_flash_decode_paged_window(cuda, dtype, hd, G):
    """The paged decode kernel's window: spans of whole pages (1, 3, 17
    and 18 of 32 rows), tails of 0, 1 and 45 rows, windows of 1, 31, 32,
    33, 100 and 1024 (so the first allowed row opens, cuts and closes a
    page, and lies in the tail or in the pages) and none. Each call is held
    to its plain version and twice bit-equal, and equals the dense decode
    kernel bit for bit on the same rows under the same window: its first
    tile and its splits are the dense kernel's. A ragged span (page 3 cut
    by 5) is held to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(hd * G + 7)
    KV, nbt, Tp, B = 2, 18, 64, 4
    H = G * KV
    P = B * nbt + 5

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    q, pk, pv = rnd(B, H, hd), rnd(P, 32, KV, hd), rnd(P, 32, KV, hd)
    tk, tv = rnd(B, Tp, KV, hd), rnd(B, Tp, KV, hd)
    pidx = torch.randperm(P, generator=g, device=cuda)[: B * nbt].reshape(
        B, nbt).to(torch.int32).contiguous()
    pages = torch.tensor([1, 3, 17, 18], device=cuda, dtype=torch.int32)
    span = pages * 32
    kd = torch.zeros(B, nbt * 32 + Tp, KV, hd, device=cuda, dtype=dtype)
    vd = torch.zeros_like(kd)
    for tail_len in (0, 1, 45):
        for b in range(B):
            n = int(span[b])
            kd[b, :n] = pk[pidx[b].long()].reshape(-1, KV, hd)[:n]
            vd[b, :n] = pv[pidx[b].long()].reshape(-1, KV, hd)[:n]
            kd[b, n:n + tail_len] = tk[b, :tail_len]
            vd[b, n:n + tail_len] = tv[b, :tail_len]
        kl = (span + tail_len).to(torch.int32)
        for window in (1, 31, 32, 33, 100, 1024, 0):
            args = (q, pk, pv, pidx, span, tk, tv, tail_len)
            got = ops.flash_decode_paged(*args, window=window)
            assert torch.equal(ops.flash_decode_paged(*args, window=window),
                               got), (tail_len, window, "two calls differ")
            _held(got, ref.flash_decode_paged_ref(*args, window=window),
                  dtype, f"flash_decode_paged window {window} tail "
                  f"{tail_len} hd {hd} G {G}")
            assert torch.equal(got, ops.flash_decode(
                q, kd, vd, kl, window or kd.shape[1])), \
                (tail_len, window, "paged != dense")
    rag = span - torch.tensor([0, 5, 5, 0], device=cuda, dtype=torch.int32)
    for window in (33, 100):
        args = (q, pk, pv, pidx, rag, tk, tv, 45)
        _held(ops.flash_decode_paged(*args, window=window),
              ref.flash_decode_paged_ref(*args, window=window), dtype,
              f"flash_decode_paged ragged window {window} hd {hd} G {G}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("bt", [16, 24, 64, 128])
@pytest.mark.parametrize("hd,G", [(128, 7), (256, 2), (64, 8), (128, 16),
                                  (96, 1), (80, 1), (112, 8)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_gpu_flash_decode_paged_page_sizes(cuda, dtype, bt, hd, G, softcap):
    """Pages of 16, 24 (no divisor of the kernel's 32-row tile), 64 and
    128 rows from a shuffled pool: spans whole and ragged (1, 33, 5 pages
    (4 at 128) cut by 5, every page), tails of 0 and 45 rows, windows none and 100,
    capped and not. Each call is held to its plain version, gives the
    same bits twice, and equals the dense decode kernel on the rows
    gathered in position order bit for bit: its tiles hold the same
    positions as the dense kernel's at every page size and span."""
    g = torch.Generator(device=cuda).manual_seed(bt * hd + G)
    KV, B, Tp = 2, 4, 64
    nbt = max(576 // bt, 2)
    H, P = G * KV, B * nbt + 5

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    q, pk, pv = rnd(B, H, hd), rnd(P, bt, KV, hd), rnd(P, bt, KV, hd)
    tk, tv = rnd(B, Tp, KV, hd), rnd(B, Tp, KV, hd)
    pidx = torch.randperm(P, generator=g, device=cuda)[: B * nbt].reshape(
        B, nbt).to(torch.int32).contiguous()
    span = torch.tensor([1, 33, min(5, nbt) * bt - 5, nbt * bt],
                        device=cuda, dtype=torch.int32)
    R = nbt * bt + Tp
    for tail_len in (0, 45):
        kd = torch.zeros(B, R, KV, hd, device=cuda, dtype=dtype)
        vd = torch.zeros_like(kd)
        for b in range(B):
            n = int(span[b])
            kd[b, :n] = pk[pidx[b].long()].reshape(-1, KV, hd)[:n]
            vd[b, :n] = pv[pidx[b].long()].reshape(-1, KV, hd)[:n]
            kd[b, n:n + tail_len] = tk[b, :tail_len]
            vd[b, n:n + tail_len] = tv[b, :tail_len]
        kl = (span + tail_len).to(torch.int32)
        for window in (0, 100):
            args = (q, pk, pv, pidx, span, tk, tv, tail_len)
            ops.reset_launches()
            got = ops.flash_decode_paged(*args, window=window,
                                         softcap=softcap)
            assert ops.LAUNCHES["flash_decode_paged"] == 1
            assert torch.equal(ops.flash_decode_paged(
                *args, window=window, softcap=softcap), got), \
                (tail_len, window, "two calls differ")
            _held(got, ref.flash_decode_paged_ref(*args, window=window,
                                                  softcap=softcap),
                  dtype, f"flash_decode_paged bt {bt} hd {hd} G {G} tail "
                  f"{tail_len} window {window} softcap {softcap}")
            assert torch.equal(got, ops.flash_decode(
                q, kd, vd, kl, window or R, softcap=softcap)), \
                (tail_len, window, "paged != dense")


RESTORE_CASES = {          # mirror diff counts, padded diff rows, shifted
    "single_mirror": ([4], 0, False),
    "zero_diffs": ([0, 0, 0], 0, False),
    "all_diffs": ([9, 9], 0, False),
    "ragged_counts": ([0, 3, 9, 1], 0, False),
    "padded_ndb": ([2, 1], 3, False),
    "shifted": ([0, 3, 9, 1], 0, True),
}


def _restore_inputs(cuda, dtype, counts, pad, shifted, L, nb, bt, KV, hd):
    g = torch.Generator(device=cuda).manual_seed(sum(counts) + pad + hd)
    M = len(counts)
    ndb = max(counts) + pad
    mk = torch.randn(L, nb, bt, KV, hd, generator=g, device=cuda).to(dtype)
    mv = torch.randn(L, nb, bt, KV, hd, generator=g, device=cuda).to(dtype)
    dk = torch.randn(M, L, ndb, bt, KV, hd, generator=g,
                     device=cuda).to(dtype)
    dv = torch.randn(M, L, ndb, bt, KV, hd, generator=g,
                     device=cuda).to(dtype)
    r = np.random.default_rng(len(counts))
    slot = np.full((M, nb), -1, np.int32)
    for m, n in enumerate(counts):
        slot[m, r.choice(nb, n, replace=False)] = np.arange(n)
    P = M * nb + 5
    pages = r.permutation(P)[: M * nb].reshape(M, nb).astype(np.int32)
    delta = (r.integers(-700, 700, (M, nb, bt)) if shifted
             else np.zeros((M, nb, bt))).astype(np.int32)
    return mk, mv, dk, dv, slot, pages, delta, P


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("case", sorted(RESTORE_CASES))
@pytest.mark.parametrize("L,nb,bt,KV,hd", [(3, 9, 32, 4, 128),
                                           (2, 9, 16, 2, 64),
                                           (2, 9, 64, 1, 256),
                                           (2, 9, 128, 2, 128),
                                           (2, 9, 128, 1, 256),
                                           (2, 9, 32, 8, 256),
                                           (2, 9, 32, 1, 80),
                                           (2, 9, 32, 2, 96),
                                           (2, 9, 32, 4, 112)])
def test_gpu_restore_kernels(cuda, dtype, case, L, nb, bt, KV, hd):
    """Both restore kernels against their plain versions, each into a
    fresh pool: bit for bit in aligned frames (pure data movement), the
    bf16/f32 tolerance in shifted ones; pages no map names stay zero.
    Tiles of more than 1024 (token, 16-byte chunk) pairs, which the
    kernel cuts into parts: bt 64 at hd 256 and bt 128 at hd 128 in f32
    (2048), bt 128 at hd 256 (2048 in bf16, 4096 in f32); Gemma3-12B's
    heads at bt 32 (KV 8, hd 256)."""
    counts, pad, shifted = RESTORE_CASES[case]
    mk, mv, dk, dv, slot, pages, delta, P = _restore_inputs(
        cuda, dtype, counts, pad, shifted, L, nb, bt, KV, hd)

    def pools():
        pk = torch.zeros(L, P, bt, KV, hd, device=cuda, dtype=dtype)
        return pk, torch.zeros_like(pk)

    args = (mk, mv, dk, dv, slot, pages, delta, 1e6)
    dkp, dvp = dk, dv       # the plain version takes the wrapper's padding
    if not dk.shape[2]:
        dkp = dvp = dk.new_zeros(dk.shape[:2] + (1,) + dk.shape[3:])
    want = ref.fused_family_restore_ref(
        mk, mv, dkp, dvp, torch.as_tensor(slot, device=cuda),
        torch.as_tensor(pages, device=cuda),
        torch.as_tensor(delta, device=cuda), 1e6, *pools())
    ops.reset_launches()
    fam = ops.fused_family_restore(*args, *pools())
    per = pools()
    for m in range(len(counts)):
        per = ops.fused_diff_restore(mk, mv, dk[m], dv[m], slot[m], pages[m],
                                     delta[m], 1e6, *per)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_family_restore"] == 1
    assert ops.LAUNCHES["fused_diff_restore"] == len(counts)
    for got in (fam, per):
        assert torch.equal(got[1], want[1])
        if shifted:
            _close(got[0], want[0], dtype)
        else:
            assert torch.equal(got[0], want[0])
    assert torch.equal(fam[0], per[0])
    unused = np.setdiff1d(np.arange(P), pages)
    assert not fam[0][:, unused].any() and not fam[1][:, unused].any()


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["out_of_range", "overlap"])
def test_gpu_restore_rejects_bad_slot_map(cuda, bad):
    mk, mv, dk, dv, slot, pages, delta, P = _restore_inputs(
        cuda, torch.bfloat16, [2, 1], 0, False, 2, 9, 32, 4, 128)
    if bad == "out_of_range":
        pages[1, 4] = P
    else:
        pages[1, 4] = pages[0, 7]
    pk = torch.zeros(2, P, 32, 4, 128, device=cuda, dtype=torch.bfloat16)
    ops.reset_launches()
    with pytest.raises(ValueError, match="slot_map"):
        ops.fused_family_restore(mk, mv, dk, dv, slot, pages, delta, 1e6, pk,
                                 torch.zeros_like(pk))
    with pytest.raises(ValueError, match="slot_map"):
        ops.fused_diff_restore(mk, mv, dk[1], dv[1], slot[1], pages[1] + P,
                               delta[1], 1e6, pk, torch.zeros_like(pk))
    assert not any(ops.LAUNCHES.values()) and not pk.any()


# ------------------------------------------------------ flash_prefill_paged
def _paged_case(seed, nbh, bt, KV, hd, T, *, H=4, B=1, n_extra_pages=3,
                share_from=None):
    """A pool + page tables (+ dense tails) and the q to attend with, as
    numpy f32 (``tests/test_kernels.py``'s case with a batch axis).
    ``share_from`` aliases the first half of each table to another table's
    pages (clean mirror blocks pointing at Master pages)."""
    rng = _rng(seed)
    P = B * nbh + n_extra_pages
    span = nbh * bt
    pool_k = rng.normal(size=(P, bt, KV, hd)).astype(np.float32)
    pool_v = rng.normal(size=(P, bt, KV, hd)).astype(np.float32)
    pidx = rng.permutation(P)[: B * nbh].reshape(B, nbh).astype(np.int32)
    if share_from is not None:
        pidx[:, : nbh // 2] = share_from[:, : nbh // 2]
    q = rng.normal(size=(B, span + T, H, hd)).astype(np.float32)
    tk = rng.normal(size=(B, T, KV, hd)).astype(np.float32) if T else None
    tv = rng.normal(size=(B, T, KV, hd)).astype(np.float32) if T else None
    return q, pool_k, pool_v, pidx, tk, tv, span


def _jax_paged(q, pk, pv, pidx, tk, tv, span, dtype, **kw):
    """The JAX wrapper over sequence 0, run as its suite runs it: the
    Pallas kernel in interpret mode. Returns [S, H, hd] as f32 numpy."""
    def j(x):
        return None if x is None else jnp.asarray(x, dtype)
    got = jops.flash_prefill_paged(
        j(q[0].transpose(1, 0, 2)), j(pk), j(pv), jnp.asarray(pidx[0]),
        j(None if tk is None else tk[0]), j(None if tv is None else tv[0]),
        span_len=span, use_kernel=True, **kw)
    return np.asarray(got.astype(jnp.float32)).transpose(1, 0, 2)


def _port_paged(q, pk, pv, pidx, tk, tv, span, dtype, **kw):
    def t(x):
        return None if x is None else _t(x).to(dtype)
    return ops.flash_prefill_paged(t(q), t(pk), t(pv), _t(pidx), t(tk), t(tv),
                                   span_len=span, **kw)[0].float().numpy()


_TOL32 = dict(atol=1e-5, rtol=1e-5)
_TOL16 = dict(atol=3e-2, rtol=3e-2)      # tests/test_kernels.py::_tol


@pytest.mark.parametrize("nbh,bt,KV,hd,T", [
    (4, 32, 2, 64, 32),     # GQA H=4 over KV=2, tail
    (2, 32, 4, 32, 0),      # no tail, H == KV
    (1, 64, 1, 128, 64),    # one page of 64
])
@pytest.mark.parametrize("window", [0, 100])
def test_flash_prefill_paged_plain_matches_pallas(nbh, bt, KV, hd, T, window):
    case = _paged_case(0, nbh, bt, KV, hd, T)
    want = _jax_paged(*case, jnp.float32, window=window, block_q=64)
    got = _port_paged(*case, torch.float32, window=window)
    np.testing.assert_allclose(got, want, **_TOL32)


@pytest.mark.parametrize("span_off,T", [(0, 32), (-5, 32), (-5, 13), (0, 13)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_paged_plain_ragged_matches_pallas(span_off, T, dtype):
    """A ragged last page (its slots past span_len unused) and ragged
    tails; bf16 operands as the JAX suite casts them."""
    q, pk, pv, pidx, tk, tv, span = _paged_case(3, 3, 32, 2, 64, T)
    span += span_off
    q = q[:, : span + T]
    if dtype == "bfloat16":
        want = _jax_paged(q, pk, pv, pidx, tk, tv, span, jnp.bfloat16,
                          block_q=64)
        got = _port_paged(q, pk, pv, pidx, tk, tv, span, torch.bfloat16)
        np.testing.assert_allclose(got, want, **_TOL16)
    else:
        want = _jax_paged(q, pk, pv, pidx, tk, tv, span, jnp.float32,
                          block_q=64)
        got = _port_paged(q, pk, pv, pidx, tk, tv, span, torch.float32)
        np.testing.assert_allclose(got, want, **_TOL32)


def test_flash_prefill_paged_plain_page_aliasing():
    """Two tables over one pool, the mirror's first half aliasing the
    Master's pages: each output tracks its own gather, and both match the
    JAX kernel."""
    q, pk, pv, master_idx, tk, tv, span = _paged_case(5, 4, 32, 2, 64, 32)
    mirror_idx = _paged_case(6, 4, 32, 2, 64, 32, share_from=master_idx)[3]
    assert not np.array_equal(master_idx, mirror_idx)
    outs = []
    for pidx in (master_idx, mirror_idx):
        got = _port_paged(q, pk, pv, pidx, tk, tv, span, torch.float32)
        want = _jax_paged(q, pk, pv, pidx, tk, tv, span, jnp.float32)
        np.testing.assert_allclose(got, want, **_TOL32)
        kd, vd = ref.paged_kv_ref(_t(pk), _t(pv), _t(pidx), _t(tk), _t(tv),
                                  span)
        S = span + tk.shape[1]
        dense = ref.flash_attention_ref(
            _t(q), kd, vd, q_pos=torch.arange(S, dtype=torch.int32)[None],
            window=2 ** 31 - 1)
        np.testing.assert_array_equal(got, dense[0].numpy())
        outs.append(got)
    assert not np.array_equal(outs[0], outs[1])


def test_flash_prefill_paged_plain_q_pos_and_non_causal():
    """Selected query positions over a paged stream equal the dense plain
    version over the gathered stream; non-causal attention matches the JAX
    kernel's ``causal=False``."""
    q, pk, pv, pidx, tk, tv, span = _paged_case(7, 3, 32, 2, 64, 32, B=2)
    qt, pkt, pvt, pit, tkt, tvt = (_t(x) for x in (q, pk, pv, pidx, tk, tv))
    sel = torch.tensor([[3, 40, 70, 100, 127], [0, 31, 32, 96, 120]],
                       dtype=torch.int32)
    qs = torch.stack([qt[b, sel[b].long()] for b in range(2)])
    got = ops.flash_prefill_paged(qs, pkt, pvt, pit, tkt, tvt, span_len=span,
                                  window=50, q_pos=sel)
    kd, vd = ref.paged_kv_ref(pkt, pvt, pit, tkt, tvt, span)
    want = ref.flash_attention_ref(qs, kd, vd, q_pos=sel, window=50)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    got = _port_paged(q[:1], pk, pv, pidx[:1], tk[:1], tv[:1], span,
                      torch.float32, causal=False)
    want = _jax_paged(q, pk, pv, pidx, tk, tv, span, jnp.float32,
                      causal=False)
    np.testing.assert_allclose(got, want, **_TOL32)


# ------------------------------------------------- counted bytes (JAX era)
BENCH = Path(__file__).resolve().parents[1] / "experiments" / "bench"


@pytest.mark.parametrize("name,paged_key,dense_key", [
    ("prefill_paged", "bytes_per_mirror_paged", "bytes_per_mirror_gather"),
    ("decode_paged", "bytes_per_step_paged", "bytes_per_step_dense"),
])
def test_paged_input_bytes_reproduce_bench_artifacts(name, paged_key,
                                                     dense_key):
    """The counted attention-input bytes of the JAX-era artifacts, at
    their recorded shapes: the paged wrappers' padded tail (the helpers
    kept beside them) and the dense stream the gather builds."""
    art = json.loads((BENCH / f"{name}.json").read_text())
    sh = art["shape"]
    assert sh["dtype"] == "float32"
    helper = (ops.paged_prefill_input_bytes if name == "prefill_paged"
              else ops.paged_decode_input_bytes)
    for row in art["sweep"]:
        pool = torch.zeros(row["pool_pages"], sh["bt"], sh["KV"], sh["hd"])
        assert helper(pool, row["tail_len"]) == row[paged_key], row
        T = row["tail_len"]
        tail = torch.zeros(1, T, sh["KV"], sh["hd"])
        pidx = torch.arange(row["span_blocks"], dtype=torch.int32)[None]
        kd, vd = ref.paged_kv_ref(pool, pool, pidx, tail, tail,
                                  row["span_len"])
        assert kd.nbytes + vd.nbytes == row[dense_key], row


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("nbh,bt,KV,hd,T,span_off,window", [
    (4, 32, 2, 64, 32, 0, 0), (4, 32, 2, 64, 32, 0, 100),
    (2, 32, 4, 32, 0, 0, 0), (2, 32, 4, 32, 0, 0, 100),
    (1, 64, 1, 128, 64, 0, 0), (1, 64, 1, 128, 64, 0, 100),
    (3, 32, 2, 64, 32, -5, 0), (3, 32, 2, 64, 13, -5, 0),
    (3, 32, 2, 64, 13, 0, 0), (18, 32, 4, 128, 32, -5, 200),
])
def test_gpu_flash_prefill_paged(cuda, dtype, nbh, bt, KV, hd, T, span_off,
                                 window):
    """The kernel equals the dense prefill kernel on the gathered stream
    bit for bit (aligned and ragged spans, any page size), and its plain
    version within the card's tolerances."""
    H = 7 * KV if hd == 128 else 2 * KV
    g = torch.Generator(device=cuda).manual_seed(nbh * 100 + bt + T)
    B, P = 3, 3 * nbh + 5
    span = nbh * bt + span_off
    S = span + T
    pk = torch.randn(P, bt, KV, hd, generator=g, device=cuda).to(dtype)
    pv = torch.randn(P, bt, KV, hd, generator=g, device=cuda).to(dtype)
    pidx = torch.randperm(P, generator=g, device=cuda)[: B * nbh].reshape(
        B, nbh).to(torch.int32)
    pidx[1, : nbh // 2] = pidx[0, : nbh // 2]          # aliased pages
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    tk = tv = None
    if T:
        tk = torch.randn(B, T, KV, hd, generator=g, device=cuda).to(dtype)
        tv = torch.randn(B, T, KV, hd, generator=g, device=cuda).to(dtype)
    ops.reset_launches()
    got = ops.flash_prefill_paged(q, pk, pv, pidx, tk, tv, span_len=span,
                                  window=window)
    assert ops.LAUNCHES["flash_prefill_paged"] == 1
    kd, vd = ref.paged_kv_ref(pk, pv, pidx, tk, tv, span)
    pos = torch.arange(S, device=cuda, dtype=torch.int32).expand(B, S)
    dense = ops.flash_attention(q, kd.contiguous(), vd.contiguous(),
                                q_pos=pos.contiguous(),
                                window=window or 2 ** 31 - 1)
    assert torch.equal(got, dense)
    want = ref.flash_attention_paged_ref(q, pk, pv, pidx, tk, tv,
                                         span_len=span, window=window)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1.6e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
def test_gpu_flash_prefill_paged_q_pos_and_non_causal(cuda, dtype):
    """Selected query positions over a paged stream equal the dense
    kernel with the same positions over the gathered stream, bit for bit;
    non-causal attention agrees with the plain version."""
    q, pk, pv, pidx, tk, tv, span = _paged_case(9, 5, 32, 4, 128, 32, H=28,
                                                B=3)
    q, pk, pv, tk, tv = (_t(x).to(cuda, dtype) for x in (q, pk, pv, tk, tv))
    pidx = _t(pidx).to(cuda)
    sel = torch.stack([torch.sort(torch.randperm(
        span + 32, generator=torch.Generator().manual_seed(b))[:70]).values
        for b in range(3)]).to(torch.int32).to(cuda)
    qs = torch.stack([q[b, sel[b].long()] for b in range(3)]).contiguous()
    kd, vd = ref.paged_kv_ref(pk, pv, pidx, tk, tv, span)
    for window in (0, 90):
        got = ops.flash_prefill_paged(qs, pk, pv, pidx, tk, tv,
                                      span_len=span, window=window,
                                      q_pos=sel)
        dense = ops.flash_attention(qs, kd.contiguous(), vd.contiguous(),
                                    q_pos=sel, window=window or 2 ** 31 - 1)
        assert torch.equal(got, dense), window
    got = ops.flash_prefill_paged(q, pk, pv, pidx, tk, tv, span_len=span,
                                  causal=False, window=100)
    want = ref.flash_attention_paged_ref(q, pk, pv, pidx, tk, tv,
                                         span_len=span, causal=False,
                                         window=100)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1.6e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
def test_gpu_prefill_kernels_stage_unaligned_rows(cuda, dtype):
    """K/V that do not start on a 16-byte boundary are staged element by
    element instead of in 16-byte words: the same values, so the same
    bits, in both prefill kernels."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, S, H, KV, hd = 2, 100, 8, 2, 64
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
    pos = torch.arange(S, device=cuda, dtype=torch.int32).expand(B, S)
    pos = pos.contiguous()
    aligned = ops.flash_attention(q, k, v, q_pos=pos, window=S)
    assert torch.equal(ops.flash_attention(q, _shifted(k), _shifted(v),
                                           q_pos=pos, window=S), aligned)
    # each sequence's 100 rows as 4 pages of 25, in order
    pk, pv = k.reshape(B * 4, 25, KV, hd), v.reshape(B * 4, 25, KV, hd)
    pidx = torch.arange(B * 4, device=cuda, dtype=torch.int32).reshape(B, 4)
    got = ops.flash_prefill_paged(q, pk, pv, pidx, span_len=S)
    assert torch.equal(got, aligned)
    assert torch.equal(ops.flash_prefill_paged(q, _shifted(pk), _shifted(pv),
                                               pidx, span_len=S), aligned)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("case", ["ragged_span", "aliased_window",
                                  "selected", "non_causal", "unaligned"])
@pytest.mark.parametrize("hd,G", EDGE_HEADS)
def test_gpu_flash_prefill_paged_edges(cuda, dtype, case, hd, G):
    """The paged prefill kernel at the same edges: spans of 149 (pages of
    32) and 141 (pages of 16) with tails of 13 and 21, so a page, a
    16-row fragment and a KV tile (64 rows in bf16, 32 in f32) are cut;
    half of table 1 aliasing table 0's pages under a binding window;
    selected query positions with a binding window; non-causal; q and the
    pool off a 16-byte boundary. Bit-equal to the dense kernel on the
    gathered stream where that kernel expresses the call (causal), two
    calls bit-equal, and held to the plain version in every case."""
    g = torch.Generator(device=cuda).manual_seed(1000 + hd + G)
    KV, B = 2, 2
    H = KV * G
    nbh, bt, cut, T = (9, 16, 3, 21) if case == "aliased_window" else \
        (5, 32, 11, 13)
    span = nbh * bt - cut
    S = span + T
    P = B * nbh + 3
    pk = torch.randn(P, bt, KV, hd, generator=g, device=cuda).to(dtype)
    pv = torch.randn(P, bt, KV, hd, generator=g, device=cuda).to(dtype)
    pidx = torch.randperm(P, generator=g, device=cuda)[: B * nbh].reshape(
        B, nbh).to(torch.int32)
    if case == "aliased_window":
        pidx[1, : nbh // 2] = pidx[0, : nbh // 2]
    pidx = pidx.contiguous()
    tk = torch.randn(B, T, KV, hd, generator=g, device=cuda).to(dtype)
    tv = torch.randn(B, T, KV, hd, generator=g, device=cuda).to(dtype)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    window, causal, q_pos = 0, True, None
    if case == "aliased_window":
        window = 70
    elif case == "selected":
        window = 60
        q_pos = torch.stack([torch.sort(torch.randperm(
            S, generator=g, device=cuda)[:83]).values for _ in range(B)]
        ).to(torch.int32).contiguous()
        q = torch.stack([q[b, q_pos[b].long()] for b in range(B)])
        q = q.contiguous()
    elif case == "non_causal":
        causal, window = False, 50
    kw = dict(span_len=span, causal=causal, window=window, q_pos=q_pos)
    ops.reset_launches()
    got = ops.flash_prefill_paged(q, pk, pv, pidx, tk, tv, **kw)
    assert ops.LAUNCHES["flash_prefill_paged"] == 1
    assert torch.equal(ops.flash_prefill_paged(q, pk, pv, pidx, tk, tv, **kw),
                       got), "two calls differ"
    if case == "unaligned":
        assert torch.equal(ops.flash_prefill_paged(
            _shifted(q), _shifted(pk), _shifted(pv), pidx, tk, tv, **kw), got)
    if causal:
        kd, vd = ref.paged_kv_ref(pk, pv, pidx, tk, tv, span)
        pos = q_pos if q_pos is not None else torch.arange(
            S, device=cuda, dtype=torch.int32).expand(B, S).contiguous()
        assert torch.equal(got, ops.flash_attention(
            q, kd.contiguous(), vd.contiguous(), q_pos=pos,
            window=window or 2 ** 31 - 1)), "paged != dense kernel"
    _held(got, ref.flash_attention_paged_ref(q, pk, pv, pidx, tk, tv, **kw),
          dtype, f"flash_prefill_paged {case} hd {hd} G {G}")


@pytest.mark.gpu
def test_gpu_flash_prefill_paged_rejects_bad_operands(cuda):
    q, pk, pv, pidx, tk, tv, span = (
        None if x is None else _t(x).to(cuda) if isinstance(x, np.ndarray)
        else x for x in _paged_case(8, 2, 32, 2, 64, 32))
    ops.reset_launches()
    with pytest.raises(ValueError, match="span_len"):   # Sq != span + T
        ops.flash_prefill_paged(q[:, :10].contiguous(), pk, pv, pidx, tk, tv,
                                span_len=span)
    with pytest.raises(ValueError, match="span_len"):   # past the table
        ops.flash_prefill_paged(q, pk, pv, pidx, tk[:, 1:].contiguous(),
                                tv[:, 1:].contiguous(), span_len=span + 1)
    with pytest.raises(TypeError):                      # mixed dtypes
        ops.flash_prefill_paged(q, pk.bfloat16(), pv, pidx, tk, tv,
                                span_len=span)
    assert ops.LAUNCHES["flash_prefill_paged"] == 0


def test_incremental_restore_reproduces_bench_artifact():
    """``restore_incremental.json``'s counted pages per round, from the
    port's engines with and without the cross-round pool (smoke qwen2.5-7b
    in f32, 3 agents, ``generative_agents`` seed 11, gen 32, ratio 0.1, the
    artifact's 6 rounds, the benchmark's JAX weights carried over), with
    equal outputs every round.

    The artifact predates later JAX-era changes: the JAX engine of this
    package no longer recomputes a history block in rounds 4-5 of this
    trace, so it writes 3 pages there, not the recorded 4 (one COW page).
    The port is held to the JAX engine on every field and round, and to
    the artifact everywhere the JAX engine still reproduces it."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.core.rounds import generate_trace as jax_trace
    from repro.models import init_params as jax_init
    from repro.serving import ServingEngine as JaxEngine
    from repro.serving import TokenDancePolicy as JaxTokenDance
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.rounds import generate_trace
    from repro_torch.models import from_jax
    from repro_torch.serving import ServingEngine, TokenDancePolicy

    art = json.loads((BENCH / "restore_incremental.json").read_text())
    assert art["workload"] == ("generative_agents, N=3, gen_len=32, "
                               "block=32, rounds=6")
    jcfg = jax_smoke("qwen2.5-7b").replace(dtype="float32")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    kw = dict(gen_len=32, recompute_ratio=0.1)
    stats = {inc: ServingEngine(params, cfg, TokenDancePolicy(incremental=inc),
                                **kw).serve(generate_trace(
                                    "generative_agents", 3, 6,
                                    cfg.vocab_size, seed=11,
                                    jitter_hist=False))
             for inc in (True, False)}
    jstats = JaxEngine(jparams, jcfg, JaxTokenDance(), **kw).serve(jax_trace(
        "generative_agents", 3, 6, jcfg.vocab_size, seed=11,
        jitter_hist=False))
    rows, jrows = [], []
    for r in range(6):
        np.testing.assert_array_equal(stats[True][r].outputs,
                                      stats[False][r].outputs)
        if r == 0:
            continue
        rf = stats[False][r].reuse["restore"]
        for out, ri in ((rows, stats[True][r].reuse["restore"]),
                        (jrows, jstats[r].reuse["restore"])):
            out.append({"round": r, "nb": ri["nb"],
                        "incremental": ri["incremental"],
                        "inc_pool_pages": ri["pool_pages"],
                        "full_pool_pages": rf["pool_pages"],
                        "pages_reused": ri.get("pages_reused", 0),
                        "new_span_pages": ri.get("new_span_pages", 0),
                        "cow_pages": ri.get("cow_pages", 0)})
    assert rows == jrows
    recorded = [{k: row[k] for k in rows[0]} for row in art["sweep"]]
    departs = {(row["round"], k) for row, rec in zip(jrows, recorded)
               for k in row if row[k] != rec[k]}
    assert departs == {(4, "inc_pool_pages"), (4, "cow_pages"),
                       (5, "inc_pool_pages"), (5, "cow_pages")}, departs
    for row, rec in zip(rows, recorded):
        for k in row:
            if (row["round"], k) not in departs:
                assert row[k] == rec[k], (row, rec)


# ------------------------------------------- the Qwen family's head layouts
# (H, KV, hd) of Qwen2.5-14B (G 5), Qwen3-4B (G 4) and Qwen2-72B (G 8, the
# decode kernels' largest group), all at head dim 128
QWEN_LAYOUTS = [(40, 8, 128), (32, 8, 128), (64, 8, 128)]
GEMMA_LAYOUTS = [(4, 1, 256), (16, 8, 256)]
# past 8 query heads a KV head: Mistral-Large-2 (G 12), Llama-3.1-405B
# (G 16 over 8), Qwen3-235B-A22B (G 16 over 4), Falcon-180B (G 29, hd 64);
# head dims 80 (Phi-2) and 96 (Phi-3-mini), one KV head a query head;
# head dim 112 at MPT-30B's 64 over 64 and at the [serve 112] layout (32
# over 4, G 8)
WIDE_LAYOUTS = [(96, 8, 128), (128, 8, 128), (64, 4, 128), (232, 8, 64),
                (32, 32, 80), (32, 32, 96), (64, 64, 112), (32, 4, 112)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("H,KV,hd", QWEN_LAYOUTS + GEMMA_LAYOUTS +
                         WIDE_LAYOUTS)
def test_gpu_attention_kernels_at_qwen_head_layouts(cuda, dtype, H, KV, hd):
    """The four attention kernels at the serving paths' new layouts (the
    Qwen family's, and Gemma3's at head dim 256), each against its plain
    version at the card's tolerance and twice for the same bits:
    ``flash_attention`` causal (S 150) and at selected query positions
    with a ragged ``kv_len``; ``flash_prefill_paged`` over 5 pages of 32
    (half aliased) and a 32-row tail, bit-equal to the dense kernel on the
    gathered rows; ``flash_decode_paged`` over 18 pages of 32 with ragged
    spans, and ``flash_decode`` on the same rows bit-equal to it, with and
    without a binding window."""
    g = torch.Generator(device=cuda).manual_seed(H + KV)
    B, S = 2, 150

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    def twice(fn, what):
        got = fn()
        assert torch.equal(fn(), got), f"{what}: two calls differ"
        return got

    q, k, v = rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)
    full = torch.arange(S, device=cuda, dtype=torch.int32).expand(
        B, S).contiguous()
    sel = torch.sort(torch.randperm(S, generator=g, device=cuda)[:64]
                     ).values.to(torch.int32).expand(B, 64).contiguous()
    kv_len = torch.tensor([S, 100], device=cuda, dtype=torch.int32)
    for qq, qp, kl, what in ((q, full, None, "fresh"),
                             (q[:, :64].contiguous(), sel, kv_len,
                              "selected")):
        got = twice(lambda: ops.flash_attention(qq, k, v, q_pos=qp, window=S,
                                                kv_len=kl), what)
        _held(got, ref.flash_attention_ref(qq, k, v, q_pos=qp, window=S,
                                           kv_len=kl), dtype,
              f"flash_prefill {what} {H}/{KV}")

    nbh, bt, T = 5, 32, 32
    P = B * nbh + 3
    pk, pv = rnd(P, bt, KV, hd), rnd(P, bt, KV, hd)
    pidx = torch.randperm(P, generator=g, device=cuda)[: B * nbh].reshape(
        B, nbh).to(torch.int32)
    pidx[1, : nbh // 2] = pidx[0, : nbh // 2]
    tk, tv = rnd(B, T, KV, hd), rnd(B, T, KV, hd)
    span = nbh * bt
    qp_ = rnd(B, span + T, H, hd)
    got = twice(lambda: ops.flash_prefill_paged(qp_, pk, pv, pidx, tk, tv,
                                                span_len=span),
                "flash_prefill_paged")
    kd, vd = ref.paged_kv_ref(pk, pv, pidx, tk, tv, span)
    pos = torch.arange(span + T, device=cuda, dtype=torch.int32).expand(
        B, span + T).contiguous()
    assert torch.equal(got, ops.flash_attention(
        qp_, kd.contiguous(), vd.contiguous(), q_pos=pos,
        window=2 ** 31 - 1)), "paged prefill != dense kernel"
    _held(got, ref.flash_attention_paged_ref(qp_, pk, pv, pidx, tk, tv,
                                             span_len=span), dtype,
          f"flash_prefill_paged {H}/{KV}")

    nbt = 18
    qd = rnd(B, H, hd)
    kk, vv = rnd(B, nbt * bt, KV, hd), rnd(B, nbt * bt, KV, hd)
    perm = torch.randperm(B * nbt, generator=g, device=cuda)
    dpk = torch.empty(B * nbt, bt, KV, hd, device=cuda, dtype=dtype)
    dpv = torch.empty_like(dpk)
    dpk[perm] = kk.reshape(B * nbt, bt, KV, hd)
    dpv[perm] = vv.reshape(B * nbt, bt, KV, hd)
    didx = perm.reshape(B, nbt).to(torch.int32).contiguous()
    lens = torch.tensor([545, 33], device=cuda, dtype=torch.int32)
    paged = twice(lambda: ops.flash_decode_paged(qd, dpk, dpv, didx, lens),
                  "flash_decode_paged")
    _held(paged, ref.flash_decode_paged_ref(qd, dpk, dpv, didx, lens), dtype,
          f"flash_decode_paged {H}/{KV}")
    dense = twice(lambda: ops.flash_decode(qd, kk, vv, lens, nbt * bt),
                  "flash_decode")
    assert torch.equal(dense, paged), "dense decode != paged decode"
    win = twice(lambda: ops.flash_decode(qd, kk, vv, lens, 100),
                "flash_decode window")
    _held(win, ref.flash_decode_ref(qd, kk, vv, lens, 100), dtype,
          f"flash_decode window {H}/{KV}")
    paged_win = twice(lambda: ops.flash_decode_paged(qd, dpk, dpv, didx, lens,
                                                     window=100),
                      "flash_decode_paged window")
    assert torch.equal(paged_win, win), "windowed dense != paged decode"


# ------------------------------------------------------- the logit soft cap
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("hd", [64, 80, 96, 112, 128, 256])
@pytest.mark.parametrize("G", [1, 6, 7, 8, 16])
@pytest.mark.parametrize("case", ["c30", "saturating"])
def test_gpu_attention_kernels_capped(cuda, dtype, hd, G, case):
    """The four attention wrappers with a logit soft cap (the capped
    instances), each against its plain version at the card's tolerance and
    twice for the same bits: ``flash_attention`` causal and at selected
    positions with a ragged ``kv_len``, ``flash_prefill_paged`` over pages
    and a tail (bit-equal to the dense kernel on the gathered rows),
    ``flash_decode_paged`` and ``flash_decode`` on the same rows (bit-equal
    to each other, with and without a binding window). ``c30`` is Grok's
    cap on unit-scale scores; ``saturating`` scales q by 300 so that |s| is
    far past c = 30 and the tanh saturates. Each capped result differs
    from the uncapped kernel's."""
    KV = 2
    H = G * KV
    g = torch.Generator(device=cuda).manual_seed(hd * G + len(case))
    B, S, c = 2, 150, 30.0
    mult = 300.0 if case == "saturating" else 1.0

    def rnd(*shape, m=1.0):
        return (m * torch.randn(*shape, generator=g, device=cuda)).to(dtype)

    def twice(fn, what):
        got = fn()
        assert torch.equal(fn(), got), f"{what}: two calls differ"
        return got

    def capped(fn, plain, what):
        got = twice(lambda: fn(softcap=c), what)
        _held(got, plain(softcap=c), dtype, f"{what} capped {case} {H}/{KV} "
              f"hd {hd}")
        assert not torch.equal(got, fn()), f"{what}: the cap changed nothing"
        return got

    q, k, v = rnd(B, S, H, hd, m=mult), rnd(B, S, KV, hd), rnd(B, S, KV, hd)
    full = torch.arange(S, device=cuda, dtype=torch.int32).expand(
        B, S).contiguous()
    sel = torch.sort(torch.randperm(S, generator=g, device=cuda)[:64]
                     ).values.to(torch.int32).expand(B, 64).contiguous()
    kv_len = torch.tensor([S, 100], device=cuda, dtype=torch.int32)
    for qq, qp, kl, what in ((q, full, None, "flash_prefill fresh"),
                             (q[:, :64].contiguous(), sel, kv_len,
                              "flash_prefill selected")):
        capped(lambda **kw: ops.flash_attention(qq, k, v, q_pos=qp, window=S,
                                                kv_len=kl, **kw),
               lambda **kw: ref.flash_attention_ref(qq, k, v, q_pos=qp,
                                                    window=S, kv_len=kl,
                                                    **kw), what)

    nbh, bt, T = 5, 32, 32
    P = B * nbh + 3
    pk, pv = rnd(P, bt, KV, hd), rnd(P, bt, KV, hd)
    pidx = torch.randperm(P, generator=g, device=cuda)[: B * nbh].reshape(
        B, nbh).to(torch.int32)
    tk, tv = rnd(B, T, KV, hd), rnd(B, T, KV, hd)
    span = nbh * bt
    qp_ = rnd(B, span + T, H, hd, m=mult)
    got = capped(lambda **kw: ops.flash_prefill_paged(
        qp_, pk, pv, pidx, tk, tv, span_len=span, **kw),
        lambda **kw: ref.flash_attention_paged_ref(
            qp_, pk, pv, pidx, tk, tv, span_len=span, **kw),
        "flash_prefill_paged")
    kd, vd = ref.paged_kv_ref(pk, pv, pidx, tk, tv, span)
    pos = torch.arange(span + T, device=cuda, dtype=torch.int32).expand(
        B, span + T).contiguous()
    assert torch.equal(got, ops.flash_attention(
        qp_, kd.contiguous(), vd.contiguous(), q_pos=pos,
        window=2 ** 31 - 1, softcap=c)), "capped paged prefill != dense"

    nbt = 18
    qd = rnd(B, H, hd, m=mult)
    kk, vv = rnd(B, nbt * bt, KV, hd), rnd(B, nbt * bt, KV, hd)
    perm = torch.randperm(B * nbt, generator=g, device=cuda)
    dpk = torch.empty(B * nbt, bt, KV, hd, device=cuda, dtype=dtype)
    dpv = torch.empty_like(dpk)
    dpk[perm] = kk.reshape(B * nbt, bt, KV, hd)
    dpv[perm] = vv.reshape(B * nbt, bt, KV, hd)
    didx = perm.reshape(B, nbt).to(torch.int32).contiguous()
    lens = torch.tensor([545, 33], device=cuda, dtype=torch.int32)
    for window in (0, 100):
        paged = capped(lambda **kw: ops.flash_decode_paged(
            qd, dpk, dpv, didx, lens, window=window, **kw),
            lambda **kw: ref.flash_decode_paged_ref(
                qd, dpk, dpv, didx, lens, window=window, **kw),
            f"flash_decode_paged window {window}")
        dense = capped(lambda **kw: ops.flash_decode(
            qd, kk, vv, lens, window or nbt * bt, **kw),
            lambda **kw: ref.flash_decode_ref(qd, kk, vv, lens,
                                              window or nbt * bt, **kw),
            f"flash_decode window {window}")
        assert torch.equal(dense, paged), "capped dense decode != paged"


@pytest.mark.gpu
def test_gpu_attention_wrappers_refuse_a_negative_cap(cuda):
    q = torch.zeros(1, 4, 2, 64, device=cuda)
    kv = torch.zeros(1, 4, 1, 64, device=cuda)
    pos = torch.arange(4, device=cuda, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention(q, kv, kv, q_pos=pos, window=4, softcap=-1.0)
