"""The port's four kernels: their plain PyTorch versions against the JAX
package's references and Pallas kernels (interpret mode) on the CPU, and —
on a card — each CUDA kernel against its plain version
(``pytest -m gpu tests/test_torch_kernels.py``)."""
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
def test_gpu_rope_align(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    k = torch.randn(28, 160, 4, 128, generator=g, device=cuda).to(dtype)
    d = torch.randint(-600, 600, (160,), generator=g, device=cuda,
                      dtype=torch.int32)
    _close(ops.rope_align(k, d, 1e6), ref.rope_delta_ref(k, d, 1e6), dtype)
    d2 = torch.randint(0, 600, (4, 160), generator=g, device=cuda,
                       dtype=torch.int32)
    _close(ops.rope_align(k.reshape(4, 7, 160, 4, 128), d2, 1e6),
           ref.rope_delta_ref(k.reshape(4, 7, 160, 4, 128), d2, 1e6), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
def test_gpu_block_diff(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    ks = torch.randn(4, 3, 100, 4, 128, generator=g, device=cuda).to(dtype)
    vs = torch.randn(4, 3, 100, 4, 128, generator=g, device=cuda).to(dtype)
    ks[2], vs[2] = ks[0], vs[0]
    out = ops.block_diff(ks, vs, 0, 32)
    assert torch.equal(out, ref.block_diff_ref(ks, vs, 0, 32))
    assert (out[2] == 0).all() and (out[1] > 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("H,KV,hd", [(28, 4, 128), (8, 2, 32)])
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
        _close(ops.flash_attention(qq, k, v, q_pos=qp, window=S, kv_len=kl),
               ref.flash_attention_ref(qq, k, v, q_pos=qp, window=S,
                                       kv_len=kl), dtype)


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
