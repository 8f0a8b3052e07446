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


GPU_CASES = [(25, 5, 64), (28, 4, 128), (10, 2, 32)]


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
    with pytest.raises(ValueError):          # G = 9 > 8
        ops.flash_decode(q, k, k, kl, 64)
    with pytest.raises(TypeError):           # kv_len not int32
        ops.flash_decode(q[:, :4].contiguous(), k, k, kl.long(), 64)
    with pytest.raises(ValueError):          # a non-contiguous query
        ops.flash_decode(q[:, :4], k, k, kl, 64)
    # the kernels load K/V rows in 16-byte words
    kx = torch.zeros(k.numel() + 1, device=cuda)[1:].view(k.shape)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_decode(q[:, :4].contiguous(), kx, k, kl, 64)

