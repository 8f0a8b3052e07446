"""The f32 x bf16 linear product: the kernel's three-way bf16 split of an
f32 activation (``ref.split_bf16x3``), the dispatch rule
(``layers.mixed_ok``), the CPU path's bits, the ``model.mixed_bytes``
counter, and — on a card — the kernel against the plain product
(``pytest -m gpu tests/test_torch_mixed.py``)."""
import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import init_params, layers, transformer

TINY = 2.0 ** -133          # bf16's least subnormal


def _values(kind, n=4096):
    """Seeded f32 values of one kind, as a tensor."""
    r = np.random.default_rng(len(kind))
    if kind == "normal":              # exponents -110 .. 127, both signs
        e = r.integers(-110, 128, n)
        m = 1 + r.random(n)
        v = np.ldexp(m, e) * r.choice([-1, 1], n)
    elif kind == "near_max":
        v = np.float32(3.4028235e38) * (1 - r.random(n) * 1e-3)
        v *= r.choice([-1, 1], n)
    elif kind == "tiny_normal":       # below 2^-110: parts under 2^-133
        v = np.ldexp(1 + r.random(n), r.integers(-126, -110, n))
        v *= r.choice([-1, 1], n)
    elif kind == "subnormal":
        bits = r.integers(1, 2 ** 23, n, dtype=np.int64).astype(np.uint32)
        v = bits.view(np.float32) * r.choice([-1, 1], n).astype(np.float32)
    elif kind == "zero":
        v = np.array([0.0, -0.0] * (n // 2))
    else:
        v = r.normal(size=n) * 10.0 ** r.integers(-6, 7, n)
    return torch.from_numpy(np.asarray(v, dtype=np.float32))


@pytest.mark.parametrize("kind", ["normal", "near_max", "tiny_normal",
                                  "subnormal", "zero", "activations"])
def test_split_bf16x3_reconstructs_f32(kind):
    x = _values(kind)
    parts = ref.split_bf16x3(x)
    for p in parts:                    # each part exact in bf16
        assert p.dtype == torch.bfloat16
        assert torch.isfinite(p).all()
    total = sum(p.double() for p in parts)
    # every f32 that is a multiple of bf16's least subnormal comes back
    # exactly; the rest (subnormals, |x| < 2^-110) lose less than it
    whole = torch.remainder(x.double(), TINY) == 0
    assert torch.equal(total[whole], x.double()[whole])
    assert ((total - x.double()).abs() < TINY).all()
    if kind in ("normal", "near_max", "zero", "activations"):
        assert whole.all()
        assert torch.equal(total.float(), x)
    # the parts shrink: x1 under x0's last bit, x2 under x1's
    x0, x1, x2 = (p.double() for p in parts)
    nz = x0 != 0
    assert (x1.abs()[nz] <= x0.abs()[nz] * 2.0 ** -7).all()


@pytest.mark.parametrize("v", [float("inf"), -float("inf"), float("nan")])
def test_split_bf16x3_non_finite(v):
    x = torch.tensor([v, 1.5, v], dtype=torch.float32)
    x0, x1, x2 = ref.split_bf16x3(x)
    assert torch.equal(x1[[0, 2]], torch.zeros(2, dtype=torch.bfloat16))
    assert torch.equal(x2[[0, 2]], torch.zeros(2, dtype=torch.bfloat16))
    if v != v:
        assert torch.isnan(x0[[0, 2]]).all()
    else:
        assert (x0[[0, 2]].float() == v).all()
    assert x0[1].item() == 1.5 and x1[1].item() == 0 and x2[1].item() == 0


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device: the predicate's
    other conditions, each alone."""

    @property
    def is_cuda(self):
        return True


def _pair(K=64, N=48, M=5):
    x = torch.randn(M, K).as_subclass(_OnCard)
    w = torch.randn(K, N).bfloat16().as_subclass(_OnCard)
    return x, w


def _misaligned(K, N):
    flat = torch.zeros(K * N + 8, dtype=torch.bfloat16)
    return flat[1:K * N + 1].view(K, N).as_subclass(_OnCard)


CASES = {
    "taken": (lambda: _pair(), True),
    "x 3-D": (lambda: (torch.randn(2, 3, 64).as_subclass(_OnCard),
                       _pair()[1]), True),
    "x bf16 (round 0)": (lambda: (_pair()[0].bfloat16(), _pair()[1]), False),
    "w f32": (lambda: (_pair()[0], _pair()[1].float()), False),
    "x on the CPU": (lambda: (torch.randn(5, 64), _pair()[1]), False),
    "w on the CPU": (lambda: (_pair()[0], torch.randn(64, 48).bfloat16()),
                     False),
    "w 3-D (stacked)": (lambda: (_pair()[0], torch.randn(
        2, 64, 48).bfloat16().as_subclass(_OnCard)), False),
    "x requires grad": (lambda: (_pair()[0].requires_grad_(), _pair()[1]),
                        False),
    "w requires grad": (lambda: (_pair()[0], _pair()[1].requires_grad_()),
                        False),
    "w not contiguous (embed.T)": (lambda: (_pair()[0], torch.randn(
        48, 64).bfloat16().as_subclass(_OnCard).T), False),
    "w not 16-byte aligned": (lambda: (_pair()[0], _misaligned(64, 48)),
                              False),
    "K % 8": (lambda: _pair(K=60), False),
    "N % 8": (lambda: _pair(N=44), False),
    "K mismatch": (lambda: (_pair(K=56)[0], _pair(K=64)[1]), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_ok_each_condition(case):
    make, want = CASES[case]
    x, w = make()
    assert layers.mixed_ok(x, w) is want


def test_mixed_ok_grad_mode_off_and_dtensor(monkeypatch):
    x, w = _pair()
    x.requires_grad_()
    with torch.no_grad():
        assert layers.mixed_ok(x, w)       # nothing recorded: taken
    monkeypatch.setattr(layers, "DTensor", _OnCard)
    assert not layers.mixed_ok(*_pair())   # a DTensor operand is refused


@pytest.mark.parametrize("xd,wd", [(torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.float32)])
def test_matmul_cpu_bits_are_the_parents(xd, wd):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 7, 64, generator=g).to(xd)
    w = torch.randn(64, 40, generator=g).to(wd)
    dt = torch.promote_types(xd, wd)
    assert torch.equal(layers.matmul(x, w), x.to(dt) @ w.to(dt))


@pytest.mark.parametrize("tied,hd", [(False, torch.float32),
                                     (False, torch.bfloat16),
                                     (True, torch.float32)])
def test_logits_of_cpu_bits_are_the_parents(tied, hd):
    cfg = get_smoke_config("qwen2.5-7b").replace(tie_embeddings=tied)
    params = init_params(cfg, 0, device="cpu")
    h = torch.randn(2, 3, cfg.d_model).to(hd)
    hn = layers.rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    table = params["embed"].T if tied else params["lm_head"]
    want = (hn @ table.to(hd)).float()
    assert torch.equal(transformer.logits_of(params, cfg, h), want)


def test_mixed_bytes_counted_where_the_kernel_is_taken(monkeypatch):
    """With the predicate taking every f32 x 2-D bf16 product and the
    launch replaced by the plain product, the weights' bf16 bytes are
    counted as ``model.mixed_bytes`` and none as ``model.cast_bytes``;
    a norm scale is still cast."""
    calls = []

    def take(x, w):
        return x.dtype == torch.float32 and w.dtype == torch.bfloat16 \
            and w.dim() == 2

    def launch(x, w):
        calls.append(tuple(w.shape))
        return ref.mixed_matmul_ref(x, w)

    monkeypatch.setattr(layers, "mixed_ok", take)
    monkeypatch.setattr(ops, "mixed_matmul", launch)
    cfg = get_smoke_config("qwen2.5-7b")
    params = init_params(cfg, 0, device="cpu")
    x = torch.randn(4, cfg.d_model)
    w = params["lm_head"]
    spans.start()
    try:
        y = layers.matmul(x, w)
        logits = transformer.logits_of(params, cfg, x[:, None])
    finally:
        spans.stop()
    _, counters = spans.drain()
    assert calls == [tuple(w.shape)] * 2
    assert torch.equal(y, x @ w.float())
    assert logits.dtype == torch.float32 and logits.shape[-1] == w.shape[1]
    assert counters == {"model.mixed_bytes": 2 * w.nbytes,
                        "model.cast_bytes":
                            params["final_norm"].nbytes}


# ------------------------------------------------------------- on a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the benchmark cells' (K, N): Qwen2.5-7B's and Qwen2.5-14B's wq/wo, wk/wv,
# gate/up, down; lm_head only at a batch's rows
LAYER_KN = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
            (5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120)]
HEAD_KN = [(3584, 152064), (5120, 152064)]
GPU_CASES = [(M, K, N) for M in (1, 8, 16, 17, 64, 65, 4096, 22528)
             for K, N in LAYER_KN + (HEAD_KN if M <= 65 else [])]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", GPU_CASES)
def test_gpu_mixed_matmul(cuda, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=cuda)
    w = (torch.randn(K, N, generator=g, device=cuda) * K ** -0.5).bfloat16()
    n0 = ops.LAUNCHES["mixed_matmul"]
    got = ops.mixed_matmul(x, w)
    assert ops.LAUNCHES["mixed_matmul"] == n0 + 1
    assert torch.equal(got, ops.mixed_matmul(x, w))     # the same bits
    torch.testing.assert_close(got, x @ w.float(), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_gpu_mixed_matmul_non_finite(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(40, 1024, generator=g, device=cuda)
    x[3, 5], x[7, 0], x[30, 1000] = float("inf"), float("nan"), \
        -float("inf")
    w = (torch.randn(1024, 264, generator=g, device=cuda) * 0.03).bfloat16()
    for rows in (x[:16], x):          # the streaming and the compute tiles
        got, want = ops.mixed_matmul(rows, w), rows @ w.float()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(16, 18944, 3584), (4096, 3584, 3584)])
def test_gpu_mixed_matmul_as_exact_as_f32(cuda, M, K, N):
    """No less exact than the f32 product it replaces: the max error
    against the float64 product within 1.5 times cuBLAS f32's, at a decode
    step's down projection and a recovery's wq. Two bf16 parts of x (16
    bits) or split TF32 (22) would miss this by far."""
    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn(M, K, generator=g, device=cuda)
    w = (torch.randn(K, N, generator=g, device=cuda) * K ** -0.5).bfloat16()
    exact = x.double() @ w.double()
    err = (ops.mixed_matmul(x, w).double() - exact).abs().max().item()
    f32 = (x @ w.float() - exact).abs().max().item()
    assert err <= 1.5 * f32, (err, f32)
