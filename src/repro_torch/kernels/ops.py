"""Dispatch for the port's kernels.

A tensor on a CUDA device goes to the hand-written Hopper kernel
(``csrc/*.cu``, built and loaded by :mod:`repro_torch.kernels.build`); a
tensor on the CPU goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`. There is no fallback from one to the
other: a CUDA call that the kernel does not take (device, dtype, shape,
contiguity) raises, and so does a launch the CUDA runtime refuses.

Every wrapper allocates its output with ``torch.empty`` (the two restore
wrappers write into the pools they are given, in place, as the TPU
kernels alias theirs; ``block_diff``'s is ``torch.zeros``, which its
blocks combine into by ``atomicMax``; the two decode wrappers also
allocate their splits' f32 scratch, and keep the splits' tickets per
stream),
launches on the current stream without synchronising, and adds one to
``LAUNCHES[<kernel>]`` where — and only where — it launches the kernel,
so a run can show that its path went through each kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"rope_align": 0, "block_diff": 0,
                            "flash_prefill": 0, "flash_prefill_paged": 0,
                            "flash_decode_paged": 0, "flash_decode": 0,
                            "fused_diff_restore": 0,
                            "fused_family_restore": 0}
#: calls each wrapper answered with its plain version (CPU tensors)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the attention and RoPE kernels are instantiated for
HEAD_DIMS = (32, 64, 128, 256)


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


def _check_rows(name: str, t: torch.Tensor, dtype) -> None:
    """A K/V operand of the decode kernels, which load its rows in
    16-byte words."""
    _check(name, t, dtype=dtype, ndim=4)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


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
_FREQS: Dict[Tuple, torch.Tensor] = {}


def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    """``ref.rope_freqs`` on the device, made once per (hd, theta, device)
    and read-only after: building it costs four launches a call."""
    key = (hd, float(theta), device)
    if key not in _FREQS:
        _FREQS[key] = ref.rope_freqs(hd, theta, device)
    return _FREQS[key]


def rope_align(k: torch.Tensor, delta: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate keys ``[A..., S, KV, hd]`` by position deltas ``[S]`` (all
    leading rows) or ``[D, S]`` (leading row ``a`` uses ``delta[a //
    (A // D)]``) — ONE launch over every leading row. The kernel takes
    the head dims of :data:`HEAD_DIMS`, keys 16-byte aligned."""
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
    if hd not in HEAD_DIMS or D == 0 or A % D:
        raise ValueError(f"bad rope_align shapes k={tuple(k.shape)} "
                         f"delta={tuple(delta.shape)}")
    if k.data_ptr() % 16:
        raise ValueError("k must be 16-byte aligned")
    freqs = _rope_freqs(hd, theta, k.device)
    out = torch.empty_like(k)
    _launch("rope_align", k.data_ptr(), out.data_ptr(), d.data_ptr(),
            freqs.data_ptr(), A, D, S, KV, hd, _DTYPES[k.dtype], _stream(k))
    return out


# --------------------------------------------------------------------------
def block_diff(ks: torch.Tensor, vs: torch.Tensor, master: int,
               bt: int) -> torch.Tensor:
    """Per-block max |x - x[master]| of a family ``[N, L, S, KV, hd]``
    over both planes: f32 ``[N, ceil(S/bt)]`` in ONE launch. A NaN in a
    block makes its value NaN, as ``amax`` does."""
    if _on_cpu("block_diff", ks, vs):
        return ref.block_diff_ref(ks, vs, master, bt)
    _check("ks", ks, ndim=5)
    _check("vs", vs, dtype=ks.dtype, ndim=5)
    if ks.shape != vs.shape or not 0 <= master < ks.shape[0] or bt <= 0:
        raise ValueError(f"bad block_diff args {tuple(ks.shape)} "
                         f"{tuple(vs.shape)} master={master} bt={bt}")
    N, L, S, KV, hd = ks.shape
    if ks.data_ptr() % 16 or vs.data_ptr() % 16 or \
            KV * hd * ks.element_size() % 16:
        raise ValueError("ks/vs must be 16-byte aligned in whole 16-byte "
                         "rows")
    # the kernel combines its blocks' maxima by atomicMax into zeros
    out = torch.zeros((N, -(-S // bt)), dtype=torch.float32,
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
            or hd not in HEAD_DIMS):
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
def paged_prefill_input_bytes(pool_k: torch.Tensor, tail_len: int) -> int:
    """Dense KV bytes a paged prefill materialises before its launch: the
    tail zero-padded to the page tile (k + v), nothing else — the span
    stays in the pool. The padding rule is the JAX wrapper's (one tile at
    least); ``experiments/bench/prefill_paged.json`` counts with it. The
    Hopper kernel reads the tail as it is, so it pads nothing."""
    P, bt, KV, hd = pool_k.shape
    t_pad = max(bt, -(-tail_len // bt) * bt)
    return 2 * t_pad * KV * hd * pool_k.element_size()


def flash_prefill_paged(q: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, page_idx: torch.Tensor,
                        tail_k: Optional[torch.Tensor] = None,
                        tail_v: Optional[torch.Tensor] = None, *,
                        span_len: int, causal: bool = True, window: int = 0,
                        q_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA flash attention whose KV stream is read from pool pages in
    place. q ``[B, Sq, H, hd]``; pools ``[P, bt, KV, hd]``; ``page_idx``
    int32 ``[B, nbh]`` (sequence b's row r < ``span_len`` is slot r % bt of
    page ``page_idx[b, r // bt]``, entries inside ``[0, P)``); tails
    ``[B, T, KV, hd]`` (rows ``span_len .. span_len + T - 1``) or None.
    Queries sit at ``q_pos`` (int32 ``[B, Sq]``), or row i at position i
    with ``Sq == span_len + T`` (the JAX wrapper's contract). Column c is
    allowed iff ``p - c < window`` (``window`` 0: unbounded) and, when
    ``causal``, ``p >= c``. Returns ``[B, Sq, H, hd]``."""
    if _on_cpu("flash_prefill_paged", q, pool_k, pool_v, page_idx, tail_k,
               tail_v, q_pos):
        return ref.flash_attention_paged_ref(
            q, pool_k, pool_v, page_idx, tail_k, tail_v, span_len=span_len,
            causal=causal, window=window, q_pos=q_pos)
    _check("q", q, ndim=4)
    _check("pool_k", pool_k, dtype=q.dtype, ndim=4)
    _check("pool_v", pool_v, dtype=q.dtype, ndim=4)
    _check("page_idx", page_idx, dtype=torch.int32, ndim=2)
    B, Sq, H, hd = q.shape
    P, bt, KV, _ = pool_k.shape
    nbh = page_idx.shape[1]
    T = 0
    if tail_k is not None:
        _check("tail_k", tail_k, dtype=q.dtype, ndim=4)
        _check("tail_v", tail_v, dtype=q.dtype, ndim=4)
        T = tail_k.shape[1]
        if (tail_v.shape != tail_k.shape or tail_k.shape[0] != B
                or tail_k.shape[2:] != pool_k.shape[2:]):
            raise ValueError(f"bad tail shapes {tuple(tail_k.shape)} "
                             f"{tuple(tail_v.shape)}")
    if q_pos is not None:
        _check("q_pos", q_pos, dtype=torch.int32, ndim=2)
        if tuple(q_pos.shape) != (B, Sq):
            raise ValueError("q_pos must be [B, Sq]")
    elif Sq != span_len + T:
        raise ValueError(f"Sq {Sq} must equal span_len + T = {span_len + T} "
                         f"without q_pos")
    if (pool_v.shape != pool_k.shape or pool_k.shape[3] != hd
            or page_idx.shape[0] != B or H % KV or hd not in HEAD_DIMS
            or not 0 < span_len <= nbh * bt or window < 0):
        raise ValueError(f"bad flash_prefill_paged args q={tuple(q.shape)} "
                         f"pool={tuple(pool_k.shape)} "
                         f"page_idx={tuple(page_idx.shape)} "
                         f"span_len={span_len} window={window}")
    out = torch.empty_like(q)
    _launch("flash_prefill_paged", q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), page_idx.data_ptr(),
            None if tail_k is None else tail_k.data_ptr(),
            None if tail_v is None else tail_v.data_ptr(), out.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(), B, Sq, H, KV, hd, bt,
            nbh, span_len, T, int(min(window, 2 ** 31 - 1)) or 2 ** 31 - 1,
            int(causal), 1.0 / math.sqrt(hd), _DTYPES[q.dtype], _stream(q))
    return out


# --------------------------------------------------------------------------
#: KV tiles of 32 rows that one split of a decode launch walks; the build
#: passes it to the kernels (``decode::kSplitTiles``)
DECODE_SPLIT_TILES = 2
#: the decode kernels' arrival tickets per (device, stream), one per
#: (KV head, sequence) pair: zero between launches (the last split of a
#: pair resets its own), so they are allocated once, zeroed, and grown
#: when a launch has more pairs. Launches on one stream run in order and
#: share them.
_DECODE_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def decode_split_plan(n_tiles: int, B: int, KV: int, G: int,
                      hd: int) -> Tuple[int, Tuple[int, int]]:
    """The split grid of a decode launch whose sequences span at most
    ``n_tiles`` 32-row tiles: ``(S, scratch shape)``. Each (KV head,
    sequence) pair gets S splits of :data:`DECODE_SPLIT_TILES` tiles,
    enough for the longest sequence, and each (pair, split) one f32
    partial of ``G * (hd + 2)`` floats (acc ``[G, hd]``, then the running
    max and sum per head). Dense: ``n_tiles = ceil(Sk / 32)``; paged:
    ``nbt + ceil(Tp / 32)``."""
    S = max(1, -(-n_tiles // DECODE_SPLIT_TILES))
    return S, (B * KV * S, G * (hd + 2))


def _split_operands(q: torch.Tensor, n_tiles: int, KV: int):
    """S, the partials' scratch, the tickets and the stream of one decode
    launch."""
    B, H, hd = q.shape
    S, shape = decode_split_plan(n_tiles, B, KV, H // KV, hd)
    stream = _stream(q)
    tickets = _DECODE_TICKETS.get((q.device, stream))
    if tickets is None or tickets.numel() < B * KV:
        tickets = torch.zeros(max(B * KV, 256), dtype=torch.int32,
                              device=q.device)
        _DECODE_TICKETS[(q.device, stream)] = tickets
    part = torch.empty(shape, dtype=torch.float32, device=q.device)
    return S, part, tickets, stream


def paged_decode_input_bytes(pool_k: torch.Tensor, tail_len: int) -> int:
    """Dense KV bytes a paged decode step materialises before its launch:
    the current round's generated tail zero-padded to the page tile
    (k + v), nothing else — the history span and every sealed round page
    stay in the pool. The JAX wrapper's rule, the prefill one's, which
    ``experiments/bench/decode_paged.json`` counts with; the Hopper kernel
    masks the tail by ``tail_len`` and pads nothing."""
    return paged_prefill_input_bytes(pool_k, tail_len)


def flash_decode_paged(q: torch.Tensor, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, page_idx: torch.Tensor,
                       span_len: torch.Tensor,
                       tail_k: Optional[torch.Tensor] = None,
                       tail_v: Optional[torch.Tensor] = None,
                       tail_len: int = 0, window: int = 0) -> torch.Tensor:
    """One query per sequence (q ``[B, H, hd]``) over its pages
    ``page_idx[b]`` of the pools ``[P, bt, KV, hd]`` (the first
    ``span_len[b]`` tokens, int32 on device), then over the first
    ``tail_len`` rows of the dense tails ``[B, Tp, KV, hd]``. Page column
    c sits at position c, tail row t at ``span_len[b] + t`` and the query
    at ``qpos = span_len[b] + tail_len - 1``: a valid column is allowed
    iff ``qpos - c < window`` (``window`` 0: unbounded)."""
    if _on_cpu("flash_decode_paged", q, pool_k, pool_v, page_idx,
               span_len, tail_k, tail_v):
        return ref.flash_decode_paged_ref(q, pool_k, pool_v, page_idx,
                                          span_len, tail_k, tail_v, tail_len,
                                          window)
    _check("q", q, ndim=3)
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        _check_rows(name, t, q.dtype)
    _check("page_idx", page_idx, dtype=torch.int32, ndim=2)
    _check("span_len", span_len, dtype=torch.int32, ndim=1)
    B, H, hd = q.shape
    P, bt, KV, _ = pool_k.shape
    if (pool_v.shape != pool_k.shape or pool_k.shape[3] != hd
            or page_idx.shape[0] != B or span_len.shape[0] != B
            or bt != 32 or H % KV or H // KV > 8
            or hd not in HEAD_DIMS or window < 0):
        raise ValueError(f"bad flash_decode_paged args q={tuple(q.shape)} "
                         f"pool={tuple(pool_k.shape)} "
                         f"page_idx={tuple(page_idx.shape)} window={window}")
    Tp = 0
    if tail_k is not None:
        _check_rows("tail_k", tail_k, q.dtype)
        _check_rows("tail_v", tail_v, q.dtype)
        Tp = tail_k.shape[1]
        if (tail_k.shape != tail_v.shape or tail_k.shape[0] != B
                or tail_k.shape[2:] != pool_k.shape[2:] or tail_len > Tp):
            raise ValueError(f"bad tail shapes {tuple(tail_k.shape)}")
    out = torch.empty_like(q)
    nbt = page_idx.shape[1]
    S, part, tickets, stream = _split_operands(q, nbt + -(-Tp // bt), KV)
    _launch("flash_decode_paged", q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), page_idx.data_ptr(), span_len.data_ptr(),
            None if tail_k is None else tail_k.data_ptr(),
            None if tail_v is None else tail_v.data_ptr(),
            out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, H, KV,
            hd, bt, nbt, Tp, tail_len if tail_k is not None else 0, S,
            int(min(window, 2 ** 31 - 1)) or 2 ** 31 - 1,
            1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    return out


# --------------------------------------------------------------------------
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, window: int) -> torch.Tensor:
    """One query per sequence (q ``[B, H, hd]``) at position
    ``kv_len[b] - 1`` over its dense KV ``[B, Sk, KV, hd]`` (``kv_len``
    int32 ``[B]`` on the device): column j is allowed iff ``j <
    kv_len[b]`` and ``kv_len[b] - 1 - j < window``. Returns
    ``[B, H, hd]``."""
    if _on_cpu("flash_decode", q, k, v, kv_len):
        return ref.flash_decode_ref(q, k, v, kv_len, window)
    _check("q", q, ndim=3)
    _check_rows("k", k, q.dtype)
    _check_rows("v", v, q.dtype)
    _check("kv_len", kv_len, dtype=torch.int32, ndim=1)
    B, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or kv_len.shape[0] != B or H % KV or H // KV > 8
            or hd not in HEAD_DIMS or window < 1):
        raise ValueError(f"bad flash_decode args q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} kv_len={tuple(kv_len.shape)} "
                         f"window={window}")
    out = torch.empty_like(q)
    S, part, tickets, stream = _split_operands(q, -(-Sk // 32), KV)
    _launch("flash_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), B, H, KV, hd, Sk, S,
            int(min(window, 2 ** 31 - 1)), 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], stream)
    return out


# --------------------------------------------------------------------------
def _host_ints(name: str, a, shape) -> np.ndarray:
    """An index map as host int32, of the given shape. Maps are checked
    here, before any upload: a jitted JAX scatter drops an out-of-range
    write, a CUDA kernel would write outside the pool."""
    if torch.is_tensor(a):
        a = a.cpu().numpy()
    a = np.asarray(a)
    if a.dtype.kind not in "iu" or a.shape != tuple(shape):
        raise ValueError(f"{name} must be integer {tuple(shape)}, got "
                         f"{a.dtype} {a.shape}")
    return np.ascontiguousarray(a, dtype=np.int32)


def _restore_maps(kernel: str, master_k, master_v, diff_k, diff_v,
                  diff_slot, slot_map, delta_pos, pool_k, pool_v, M: int):
    """Shape checks and the host-side map checks shared by the two
    restore kernels, on the family layout (diffs ``[M, L, ndb, ...]``,
    maps ``[M, nb]``). Returns the (possibly padded) diffs and the maps
    as host int32."""
    if master_k.dim() != 5 or master_v.shape != master_k.shape:
        raise ValueError(f"master must be [L, nb, bt, KV, hd], got "
                         f"{tuple(master_k.shape)} {tuple(master_v.shape)}")
    L, nb, bt, KV, hd = master_k.shape
    if diff_k.shape[2] == 0:  # keep the row select total: one zero row
        zshape = diff_k.shape[:2] + (1,) + diff_k.shape[3:]
        diff_k = master_k.new_zeros(zshape)
        diff_v = master_v.new_zeros(zshape)
    ndb = diff_k.shape[2]
    P = pool_k.shape[1]
    if (diff_k.shape != (M, L, ndb, bt, KV, hd) or diff_v.shape != diff_k.shape
            or pool_k.dim() != 5 or pool_v.shape != pool_k.shape
            or pool_k.shape[0] != L or pool_k.shape[2:] != master_k.shape[2:]):
        raise ValueError(f"bad {kernel} shapes: master {tuple(master_k.shape)}"
                         f" diff {tuple(diff_k.shape)} pool "
                         f"{tuple(pool_k.shape)}")
    slot = _host_ints("diff_slot", diff_slot, (M, nb))
    pages = _host_ints("slot_map", slot_map, (M, nb))
    delta = _host_ints("delta_pos", delta_pos, (M, nb, bt))
    if ((slot < -1) | (slot >= ndb)).any():
        raise ValueError(f"diff_slot out of range [-1, {ndb})")
    if ((pages < 0) | (pages >= P)).any():
        raise ValueError(f"slot_map addresses a page outside [0, {P})")
    if np.unique(pages).size != pages.size:
        raise ValueError("slot_map pages must be distinct (disjoint across "
                         "mirrors)")
    return diff_k, diff_v, slot, pages, delta


def restore_launcher(kernel: str, master_k, master_v, diff_k, diff_v,
                     diff_slot, slot_map, delta_pos, theta: float, pool_k,
                     pool_v):
    """One restore kernel's launch on CUDA tensors, checked and uploaded
    once: returns a zero-argument function that launches the kernel
    (counted in ``LAUNCHES``) and returns the pools. Arguments are in the
    family layout for both kernels (``fused_diff_restore`` takes M = 1).
    The wrappers below call it once; a measurement can time the launch
    apart from the host-side checks."""
    M = diff_k.shape[0]
    if kernel == "fused_diff_restore" and M != 1:
        raise ValueError("fused_diff_restore restores one mirror")
    diff_k, diff_v, slot, pages, delta = _restore_maps(
        kernel, master_k, master_v, diff_k, diff_v, diff_slot, slot_map,
        delta_pos, pool_k, pool_v, M)
    L, nb, bt, KV, hd = master_k.shape
    for name, x in (("master_k", master_k), ("master_v", master_v),
                    ("diff_k", diff_k), ("diff_v", diff_v),
                    ("pool_k", pool_k), ("pool_v", pool_v)):
        if x.device.type != "cuda" or x.device != master_k.device:
            raise ValueError(f"{name} must lie on the master's CUDA device")
        _check(name, x, dtype=None if name == "master_k" else master_k.dtype)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lanes = 16 // master_k.element_size()
    if hd % 16 or bt * (hd // 2) // lanes > 1024:
        raise ValueError(f"{kernel} takes hd % 16 == 0 and at most 1024 "
                         f"(token, 16-byte chunk) pairs a head, got bt {bt} "
                         f"hd {hd}")
    dev = master_k.device
    up = [torch.from_numpy(a).to(dev) for a in (slot, pages, delta)]
    freqs = ref.rope_freqs(hd, theta, dev)
    args = (master_k.data_ptr(), master_v.data_ptr(), diff_k.data_ptr(),
            diff_v.data_ptr(), *(u.data_ptr() for u in up), freqs.data_ptr(),
            pool_k.data_ptr(), pool_v.data_ptr(),
            *((M,) if kernel == "fused_family_restore" else ()),
            L, nb, diff_k.shape[2], bt, KV, hd, pool_k.shape[1],
            _DTYPES[master_k.dtype], _stream(master_k))

    def launch(_alive=(diff_k, diff_v, up, freqs)):  # buffers args point at
        _launch(kernel, *args)
        return pool_k, pool_v

    return launch


def _restore(kernel: str, master_k, master_v, diff_k, diff_v, diff_slot,
             slot_map, delta_pos, theta: float, pool_k, pool_v):
    """CPU tensors -> the plain version; CUDA tensors -> the kernel."""
    if not _on_cpu(kernel, master_k, master_v, diff_k, diff_v, pool_k,
                   pool_v):
        return restore_launcher(kernel, master_k, master_v, diff_k, diff_v,
                                diff_slot, slot_map, delta_pos, theta,
                                pool_k, pool_v)()
    diff_k, diff_v, slot, pages, delta = _restore_maps(
        kernel, master_k, master_v, diff_k, diff_v, diff_slot, slot_map,
        delta_pos, pool_k, pool_v, diff_k.shape[0])
    slot, pages, delta = (torch.from_numpy(a) for a in (slot, pages, delta))
    if kernel == "fused_diff_restore":
        return ref.fused_diff_restore_ref(
            master_k, master_v, diff_k[0], diff_v[0], slot[0], pages[0],
            delta[0], theta, pool_k, pool_v)
    return ref.fused_family_restore_ref(master_k, master_v, diff_k, diff_v,
                                        slot, pages, delta, theta, pool_k,
                                        pool_v)


def fused_diff_restore(master_k, master_v, diff_k, diff_v, diff_slot,
                       slot_map, delta_pos, theta: float, pool_k, pool_v):
    """Algorithm 1 for one mirror: block-sparse diff select + RoPE
    recovery + paged write, IN PLACE into the pools (returned).

    master ``[L, nb, bt, KV, hd]``; diffs ``[L, ndb, bt, KV, hd]`` (ndb
    may be 0); ``diff_slot``/``slot_map`` int ``[nb]`` and ``delta_pos``
    int ``[nb, bt]`` as host arrays (numpy or tensors, checked on the
    host: pages distinct and inside the pool); pools ``[L, P, bt, KV,
    hd]``. ONE launch.
    """
    return _restore("fused_diff_restore", master_k, master_v, diff_k[None],
                    diff_v[None], _lead(diff_slot), _lead(slot_map),
                    _lead(delta_pos), theta, pool_k, pool_v)


def fused_family_restore(master_k, master_v, diff_k, diff_v, diff_slot,
                         slot_map, delta_pos, theta: float, pool_k, pool_v):
    """Algorithm 1 for a whole Master family in ONE launch: each Master
    block is read once and written for all M mirrors, IN PLACE into the
    pools (returned).

    master ``[L, nb, bt, KV, hd]``; diffs ``[M, L, ndb, bt, KV, hd]``;
    ``diff_slot``/``slot_map`` int ``[M, nb]`` (pages disjoint across
    mirrors) and ``delta_pos`` int ``[M, nb, bt]``, checked on the host
    as for :func:`fused_diff_restore`; pools ``[L, P, bt, KV, hd]``.
    """
    return _restore("fused_family_restore", master_k, master_v, diff_k,
                    diff_v, diff_slot, slot_map, delta_pos, theta, pool_k,
                    pool_v)


def _lead(a):
    """One leading axis on an index map (array-like or tensor)."""
    return a[None] if torch.is_tensor(a) else np.asarray(a)[None]
