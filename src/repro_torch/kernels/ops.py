"""Dispatch for the port's four kernels.

A tensor on a CUDA device goes to the hand-written Hopper kernel
(``csrc/*.cu``, built and loaded by :mod:`repro_torch.kernels.build`); a
tensor on the CPU goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`. There is no fallback from one to the
other: a CUDA call that the kernel does not take (device, dtype, shape,
contiguity) raises, and so does a launch the CUDA runtime refuses.

Every wrapper allocates its output with ``torch.empty``, launches on the
current stream without synchronising, and adds one to
``LAUNCHES[<kernel>]`` where — and only where — it launches the kernel,
so a run can show that its path went through each kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import ref

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"rope_align": 0, "block_diff": 0,
                            "flash_prefill": 0, "flash_decode_paged": 0}
#: calls each wrapper answered with its plain version (CPU tensors)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = PLAIN_CALLS[k] = 0


def _on_cpu(kernel: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (the plain path, counted in
    ``PLAIN_CALLS``); False when every one lies on one CUDA device (the
    kernel path). Anything else is an error — a call never mixes the two."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        PLAIN_CALLS[kernel] += 1
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors
                                  if t is not None}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                     f"device, got {sorted(kinds)}")


def _check(name: str, t: torch.Tensor, dtype=None, ndim=None) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if dtype is None and t.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(kernel: str, *args) -> None:
    """Launch through the C interface; it returns cudaGetLastError(), so
    a refused launch raises here, where it happened."""
    from repro_torch.kernels.build import launcher

    rc = launcher(kernel)(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    LAUNCHES[kernel] += 1


# --------------------------------------------------------------------------
def rope_align(k: torch.Tensor, delta: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate keys ``[A..., S, KV, hd]`` by position deltas ``[S]`` (all
    leading rows) or ``[D, S]`` (leading row ``a`` uses ``delta[a //
    (A // D)]``) — ONE launch over every leading row."""
    if _on_cpu("rope_align", k, delta):
        return ref.rope_delta_ref(k, delta, theta)
    S, KV, hd = k.shape[-3:]
    A = k.numel() // (S * KV * hd) if k.numel() else 0
    d = delta.reshape(-1, S)
    D = d.shape[0]
    _check("k", k)
    if d.dtype != torch.int32:
        raise TypeError("delta must be int32")
    d = d.contiguous()
    if hd % 2 or D == 0 or A % D:
        raise ValueError(f"bad rope_align shapes k={tuple(k.shape)} "
                         f"delta={tuple(delta.shape)}")
    freqs = ref.rope_freqs(hd, theta, k.device)
    out = torch.empty_like(k)
    _launch("rope_align", k.data_ptr(), out.data_ptr(), d.data_ptr(),
            freqs.data_ptr(), A, D, S, KV, hd, _DTYPES[k.dtype], _stream(k))
    return out


# --------------------------------------------------------------------------
def block_diff(ks: torch.Tensor, vs: torch.Tensor, master: int,
               bt: int) -> torch.Tensor:
    """Per-block max |x - x[master]| of a family ``[N, L, S, KV, hd]``
    over both planes: f32 ``[N, ceil(S/bt)]`` in ONE launch."""
    if _on_cpu("block_diff", ks, vs):
        return ref.block_diff_ref(ks, vs, master, bt)
    _check("ks", ks, ndim=5)
    _check("vs", vs, dtype=ks.dtype, ndim=5)
    if ks.shape != vs.shape or not 0 <= master < ks.shape[0] or bt <= 0:
        raise ValueError(f"bad block_diff args {tuple(ks.shape)} "
                         f"{tuple(vs.shape)} master={master} bt={bt}")
    N, L, S, KV, hd = ks.shape
    out = torch.empty((N, -(-S // bt)), dtype=torch.float32,
                      device=ks.device)
    _launch("block_diff", ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
            N, L, S, KV * hd, bt, master, _DTYPES[ks.dtype], _stream(ks))
    return out


# --------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_pos: torch.Tensor, window: int,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA attention of queries at positions ``q_pos`` ([B, Sq] int32)
    over dense KV; q ``[B, Sq, H, hd]``, k/v ``[B, Sk, KV, hd]``, the
    layout of ``models.layers``. Column j is allowed iff ``0 <= q_pos -
    j < window`` and ``j < kv_len[b]``. Returns ``[B, Sq, H, hd]``."""
    if _on_cpu("flash_prefill", q, k, v, q_pos, kv_len):
        return ref.flash_attention_ref(q, k, v, q_pos=q_pos, window=window,
                                       kv_len=kv_len)
    _check("q", q, ndim=4)
    _check("k", k, dtype=q.dtype, ndim=4)
    _check("v", v, dtype=q.dtype, ndim=4)
    _check("q_pos", q_pos, dtype=torch.int32, ndim=2)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or H % KV or tuple(q_pos.shape) != (B, Sq)
            or hd not in (32, 64, 128)):
        raise ValueError(f"bad flash_attention shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} q_pos={tuple(q_pos.shape)}")
    if kv_len is not None:
        _check("kv_len", kv_len, dtype=torch.int32, ndim=1)
        if kv_len.shape[0] != B:
            raise ValueError("kv_len must be [B]")
    window = int(min(window, 2 ** 31 - 1))
    out = torch.empty_like(q)
    _launch("flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), q_pos.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(),
            B, Sq, Sk, H, KV, hd, window, 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], _stream(q))
    return out


# --------------------------------------------------------------------------
def flash_decode_paged(q: torch.Tensor, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, page_idx: torch.Tensor,
                       span_len: torch.Tensor,
                       tail_k: Optional[torch.Tensor] = None,
                       tail_v: Optional[torch.Tensor] = None,
                       tail_len: int = 0) -> torch.Tensor:
    """One query per sequence (q ``[B, H, hd]``) over its pages
    ``page_idx[b]`` of the pools ``[P, bt, KV, hd]`` (the first
    ``span_len[b]`` tokens, int32 on device), then over the first
    ``tail_len`` rows of the dense tails ``[B, Tp, KV, hd]``."""
    if _on_cpu("flash_decode_paged", q, pool_k, pool_v, page_idx,
               span_len, tail_k, tail_v):
        return ref.flash_decode_paged_ref(q, pool_k, pool_v, page_idx,
                                          span_len, tail_k, tail_v, tail_len)
    _check("q", q, ndim=3)
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        _check(name, t, dtype=q.dtype, ndim=4)
    _check("page_idx", page_idx, dtype=torch.int32, ndim=2)
    _check("span_len", span_len, dtype=torch.int32, ndim=1)
    B, H, hd = q.shape
    P, bt, KV, _ = pool_k.shape
    if (pool_v.shape != pool_k.shape or pool_k.shape[3] != hd
            or page_idx.shape[0] != B or span_len.shape[0] != B
            or bt != 32 or H % KV or H // KV > 8
            or hd not in (32, 64, 128)):
        raise ValueError(f"bad flash_decode_paged shapes q={tuple(q.shape)} "
                         f"pool={tuple(pool_k.shape)} "
                         f"page_idx={tuple(page_idx.shape)}")
    Tp = 0
    if tail_k is not None:
        _check("tail_k", tail_k, dtype=q.dtype, ndim=4)
        _check("tail_v", tail_v, dtype=q.dtype, ndim=4)
        Tp = tail_k.shape[1]
        if (tail_k.shape != tail_v.shape or tail_k.shape[0] != B
                or tail_k.shape[2:] != pool_k.shape[2:] or tail_len > Tp):
            raise ValueError(f"bad tail shapes {tuple(tail_k.shape)}")
    out = torch.empty_like(q)
    _launch("flash_decode_paged", q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), page_idx.data_ptr(), span_len.data_ptr(),
            None if tail_k is None else tail_k.data_ptr(),
            None if tail_v is None else tail_v.data_ptr(),
            out.data_ptr(), B, H, KV, hd, bt, page_idx.shape[1], Tp,
            tail_len if tail_k is not None else 0, 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], _stream(q))
    return out
