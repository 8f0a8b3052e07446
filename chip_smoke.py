"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. the card (``nvidia-smi`` name and power limit, torch's device name);
  2. the build of the ten CUDA kernels from the ten sources of
     ``src/repro_torch/kernels/csrc`` (the attention backward's bf16 and
     f32 instances in two; one ``nvcc`` per source, all at once), with
     ptxas' registers, shared memory and spills;
  3. the main path: Qwen2.5-7B at full width (28 layers, bf16, random
     weights from seed 0) served by ``ServingEngine(params, cfg)`` with its
     defaults — ``TokenDancePolicy()``, whose cross-round page pool makes
     round 2's restore write only the round delta — on the 8-agent,
     3-round ``agent_society`` trace. Kernel launch counts are zeroed just
     before and read just after; every kernel of the path must have
     launched and no plain version may have run. Inputs of each kernel's
     largest call are kept, and so is the paged history round 2 hands to
     the collector (``PagedPrivate``: the pool, 8 page tables, the tails).
     Then [full]: ``TokenDancePolicy(incremental=False)`` on the same
     weights and trace — outputs, first-token logits and persistent bytes
     bit-equal to the main path, more restore pages in round 2. Then
     [dense]: the default policy with ``paged_decode=False`` (the dense
     decode loop): ``flash_decode`` launched, ``flash_decode_paged`` did
     not, everything bit-equal to the main path;
  4. each kernel against its plain PyTorch version on those main-path
     inputs (bf16, and cast to f32) and on edge cases, with CUDA-event
     times of kernel, plain version and one PyTorch library call;
     ``rope_align`` at both of the path's calls (the shared blocks', one
     delta row for every layer, and the decode tails', one a request) and
     ``block_diff`` at the path's family and at 16 members, each in both
     types and twice for the same bits, and ``block_diff`` with a NaN in
     a mirror's block and in the Master's (NaN in those cells only, as
     the plain version gives); the prefill kernel is timed at the path's
     largest call in f32 (the recovery of rounds >= 1) and in bf16, and at
     round 0's bf16 prefill, each beside SDPA and its bound; the paged decode kernel is timed at
     the path's call in bf16 and f32 and called twice for the same bits,
     with the host time of one wrapper call;
  5. [paged_prefill] ``flash_prefill_paged`` over the main path's round-2
     history pool, one causal launch per layer (28, counts zeroed before
     and read after), at Qwen2.5-7B heads (28 over 4, head dim 128, pages
     of 32) with q from a seeded generator; per layer bit-equal to the
     dense prefill kernel on the gathered stream and within tolerance of
     the plain version, then on the same pages with the span cut by 5
     tokens, with a binding window and with half of every table aliasing
     table 0's pages, in f32 (the pool's dtype) and on a bf16 copy; CUDA-event times of the kernel, the dense kernel on the
     gathered rows, the plain version and SDPA over the gathered rows;
  6. [prefix] the vLLM prefix-caching baseline,
     ``ServingEngine(params, cfg, "prefix")``, on the main path's weights
     and trace (counts zeroed before, read after): ``flash_prefill`` and
     ``flash_decode_paged`` launched, no plain version, round 0 bit-equal
     to the main path's; per round the recover / decode / store times,
     the reused prefix and the persistent bytes an agent beside the main
     path's; then round 2's ``extend`` call (bf16, queries at positions
     p..S-1 over S rows, ``kv_len`` S) against the plain version in bf16
     and f32, twice for the same bits, timed beside SDPA with a mask;
  7. [slo] the default engine under a ``RoundPlanner`` whose model is the
     main path's round 2 (8 agents, collective) with a pool budget of 4
     agents' state, ``refit_every=1``: the first cap binds between 1 and
     8, each round admits min(cap, 8) agents in round-robin order, and
     every deferred agent's session is untouched that round;
  8. [continuous] ``ContinuousEngine`` (TokenDance, 6 agents in
     committees of 2, ``generative_agents`` 3 rounds, arrivals 0, 8, 16)
     at full width against the synchronized engine on the same topology:
     per-agent outputs and first-token logits bit-equal, counted
     makespan below the synchronized one, every TokenDance kernel
     launched and no plain version;
  8a. [pages] the main path's weights and trace served at other page
     sizes: ``ServingEngine(params, cfg, block_select=16)`` (gen 32) and
     ``block_select=64, gen_len=64``, counts zeroed before and read after
     (``flash_prefill``, ``flash_decode_paged``, ``rope_align`` and
     ``block_diff`` launched, no plain version), per-round recover /
     restore / decode / store times and restore pages; each again with
     ``paged_decode=False``: outputs, first-token logits and persistent
     bytes bit-equal; the paged decode kernel at each run's largest call
     against its plain version (bf16 and f32, twice for the same bits),
     timed in f32 beside SDPA over the gathered rows and its bound;
  8b. [page edges] ``flash_decode_paged`` at pages of 16, 24, 32, 64 and
     128 rows (576 positions, span 571), at Qwen2.5-7B's heads (hd 128)
     and Gemma3-12B's (hd 256), bf16 and f32: as it is, with a binding
     window, capped at 30 and with a tail; each held to its plain
     version, twice bit-equal and bit-equal to the dense decode kernel
     on the gathered rows; timed beside SDPA and its bound;
  8c. [heads] the kernels at the attention shapes of one layer of seven
     public models at their published head widths (8 sequences, a span
     of 545, pages of 32): the decode pair at Mistral-Large-2's G 12 (96
     over 8), Llama-3.1-405B's G 16 (128 over 8), Qwen3-235B-A22B's G 16
     (64 over 4) and Falcon-180B's G 29 (232 over 8, head dim 64), and at
     Phi-2's head dim 80, Phi-3-mini's 96 (32 over 32) and MPT-30B's 112
     (64 over 64) the decode pair, the prefill pair (dense and paged),
     ``rope_align``, ``block_diff`` and both restores; bf16 and f32,
     windowed, capped and tailed where the kernel takes it; each call
     against its plain version and twice bit-equal, paged == dense bit
     for bit, timed beside its bound and SDPA where SDPA computes the same
     function. Then the attention backward at one training layer (q [1,
     4096, H, hd]) of Phi-2's layout (32 over 32, hd 80), Phi-3-mini's (hd
     96) and 32 over 8 at hd 112, in bf16 and f32: causal, capped at 30
     and with a binding window and kv_len, each against its plain version
     and twice bit-equal, the causal call timed beside its bound and
     SDPA's backward;
  8d. [heads serve] ``ServingEngine(params, cfg)`` with its defaults on
     the main path's trace at the smoke Qwen2.5-7B config with its heads
     replaced (16 over 1 at head dim 96; 8 over 2 at head dim 80; weights
     random from seed 0): counts zeroed before and read after, every
     main-path kernel launched and no plain version; each again with
     ``paged_decode=False``, bit-equal;
  9. [forward] ``transformer.forward`` on the main path's weights over
     tokens [8, 544] from a seeded generator: 28 ``flash_prefill``
     launches and no plain version, logits bit-equal to
     ``prefill(max_len=544)``'s, ``return_hidden`` the pre-norm state
     they are read from, a CUDA-event time. Then the main path's weights
     are dropped and the allocated bytes printed: they must fall by the
     weights' size with no ``gc.collect()`` (no reference cycle holds an
     engine), as after each of the next three phases;
  9a. [serve 112] the main path's Qwen2.5-7B at full width and depth (28
     layers, d 3584, bf16, seed 0) with its heads replaced by 32 query
     heads over 4 at head dim 112 (G 8; the main path's weight sizes)
     through ``ServingEngine(params, cfg)`` with its defaults on the main
     path's trace, then again with ``paged_decode=False``: outputs,
     first-token logits and persistent bytes bit-equal; every main-path
     kernel launched and no plain version; each kernel of the path held
     and timed as [qwen2.5-14b] holds its own;
  10. [qwen2.5-14b] Qwen2.5-14B at full width (48 layers, 40 query heads
     over 8, G 5, head dim 128, bf16 weights random from seed 0) served
     by ``ServingEngine(params, cfg)`` on the main path's trace (counts
     zeroed before, read after; every main-path kernel launched, no plain
     version), with per-round persistent bytes an agent, compression and
     restore pages, and the peak memory; then every kernel of the path
     against its plain version on that run's largest calls (the fresh,
     selective and round-0 prefill calls, paged decode, both alignment
     calls, block_diff) in bf16 and f32, twice for the same bits, with
     CUDA-event times, bound and SDPA of the f32 calls;
  11. [qwen3-4b] Qwen3-4B at full width (36 layers, G 4, ``qk_norm``) the
     same way (checks without times), then with ``paged_decode=False`` on
     the same weights: outputs, first-token logits and persistent bytes
     bit-equal to the paged run (``qk_norm`` reaches both decode loops
     through one projection);
  12. [qwen2-72b] Qwen2-72B at its published widths (d 8192, 64 query
     heads over 8, G 8: the decode kernels' largest group) with the depth
     cut to 20 of 80 layers, as [qwen2.5-14b], timed (from here on the
     timed phases also time round 0's bf16 prefill);
  12a. [gemma3-1b] Gemma3-1B at full width (26 layers, 4 query heads over
     1, head dim 256, tied embeddings, window 512 on 5 layers of 6, bf16,
     seed 0) as [qwen3-4b]: its window binds in rounds 1 and 2 (544 and
     576 rows), so the dense loop's bit-equality checks the paged decode
     kernel's window; ``flash_decode`` on the dense loop's largest call
     against its plain version, timed;
  12b. [gemma3-12b] Gemma3-12B at full width (48 layers, 16 over 8, head
     dim 256, window 1024, which never binds on this trace) as
     [qwen2.5-14b], timed;
  12c. [gemma3 hd256] the attention kernels at head dim 256 with a
     binding window of 1024 at Sk 1536 and ragged lengths, at both
     Gemma3 head layouts in bf16 and f32: ``flash_decode`` and
     ``flash_decode_paged`` bit-equal to each other, ``flash_prefill``
     and ``flash_prefill_paged`` (span 1491 in pages, a tail of 45)
     bit-equal to each other, each against its plain version and twice
     for the same bits, timed at 12B's heads in f32;
  12d. [grok-1-314b] Grok-1 at its published widths (48 query heads over
     8, G 6, 8 experts top 2, logit softcap 30) with the depth cut to 4 of
     64 layers, as [qwen2.5-14b] (two layers fresh, two selective in the
     recovery), timed: every attention call runs a capped kernel instance,
     held against its capped plain version in bf16 and f32 (no library
     time: SDPA has no soft cap); then with ``paged_decode=False``:
     outputs, first-token logits and persistent bytes bit-equal,
     ``flash_decode`` launched and held capped;
  12e. [arctic-480b] Arctic (56 over 8, 128 experts, dense residual) cut to
     2 of 35 layers, served with ``check_layer=0`` (one fresh layer, one
     selective), its peak memory under the card's;
  12f. [mamba2-2.7b] Mamba2-2.7B at full width and depth (64 layers, 80
     SSM heads of 64, state 128): TokenDance falls back to recompute and
     the dense decode loop; no kernel launched and no plain version run,
     finite first-token logits, nothing persistent; then the prefix
     policy, constructed as in JAX, recomputing every round bit-equal to
     the fallback (nothing cached);
  12g. [musicgen-large] MusicGen-large at full width (48 layers, KV = H =
     32, G 1, hd 64) served, then ``prefill`` of tokens [8, 224] with
     seeded audio frontend embeddings [8, 64, 2048] on the first
     positions: one launch a layer, logits bit-equal to ``forward``'s;
  12h. [chameleon-34b] Chameleon-34B (64 over 8, ``qk_norm``, vision
     frontend) cut to 24 of 48 layers, the same way, its peak memory
     under the card's;
  12i. [softcap edges] the capped instances with q scaled by 300 (|s| far
     past the cap of 30): ``flash_prefill_paged`` at the main path's
     round-2 pool shape (bit-equal to the dense kernel, timed in f32 on
     a line of its own, not in the kernel table: no path makes these
     calls), and head dim 256 in ``flash_attention`` and both decode
     kernels (bit-equal to each other), in bf16 and f32;
  13. [hybrid] Hymba-1.5B at full width (32 layers, bf16, random weights
     from seed 0) served by ``ServingEngine(params, cfg, "tokendance")``
     on the same trace: the engine falls back to the recompute policy and
     the dense decode loop; counts zeroed before and read after,
     ``flash_prefill`` and ``flash_decode`` launched, ``flash_decode_paged``
     and every plain version did not. Then the ``flash_prefill`` kernel
     against its plain version at the hybrid heads (25 over 5, head dim
     64) on the path's largest prefill (timed in bf16 and f32 beside
     SDPA and its bound) and at S 1536 with a binding window of 1024, in
     bf16 and f32; and the ``flash_decode`` kernel
     against its plain version on the hybrid path's inputs and on the
     dense Qwen path's, each in bf16 and f32, twice for the same bits and
     bit-equal to the paged kernel on identical KV, and at Sk 1536 with a
     binding window of 1024 and ragged lengths, and at Sk 4096 (more
     than 32 splits a pair); CUDA-event times of kernel, plain version
     and SDPA with a mask in both types, and the host time of one call;
  13a. [train] Qwen3-4B at full width and depth (36 layers, bf16 weights
     random from seed 0) trained by ``repro_torch.training`` on
     ``SyntheticTokens`` batches of 1 x 4096 with ``remat=True``: one
     step with the counts zeroed before and read after (72
     ``flash_prefill``, 36 ``flash_prefill_bwd``, no plain version), one
     step with CUDA events between forward, backward and optimizer, then
     3 steps through ``train`` (tokens/s); finite losses; the peak memory;
     the weights freed. Then the backward kernel against its plain
     version at that layer's shape (q [1, 4096, 32, 128], k/v [1, 4096,
     8, 128], causal) in bf16 and f32, twice for the same bits, timed
     beside its bound (with the rate its products make in the kernel's
     time) and SDPA's backward, and at the edges (head dims 64
     / 128 / 256, G 1 / 4 / 8, binding windows, ragged kv_len, softcap
     30); [train parity]: one step's gradients at full width cut to 2
     layers with the kernels against the same step with attention routed
     to the plain forward and backward (a spy on ``ops``), leaf by leaf;
     [train heads]: Qwen3-4B at full width and depth with Phi-3-mini's
     heads (32 over 32, head dim 96) as [train] trains it (two steps: the
     counted one and the timed one; the peak memory); [train heads
     parity]: [train parity] at Phi-2's heads (32 over 32, hd 80),
     Phi-3-mini's and 32 over 8 at hd 112;
     [examples]: the four example twins (``train_small``,
     ``multi_agent_serving``, ``slo_admission``, ``continuous_serving``)
     at small arguments on the card;
  13b. [launch] ``repro_torch.launch`` on the card: (a) Qwen3-4B at full
     width and depth in f32 (tokens [2, 512] from seed 1) through
     ``forward`` with DTensor parameters from ``distribute_params`` over
     ``make_debug_mesh()`` (a one-rank nccl group, mesh (1, 1)) and
     ``shard=rules.shard``: logits within atol 1e-5 of the unsharded
     ``forward``'s, 36 ``flash_prefill`` launches and no plain version
     (counts zeroed before, read after), both forwards timed with CUDA
     events, the group destroyed; (b) the [train] step's share of the
     bf16 peak in model FLOPs (``roofline.model_flops_for``), printed by
     [train]; (c) ``python -m repro_torch.launch.dryrun --arch qwen2-72b
     --shape train_4k --mesh single`` in a subprocess writing to a
     temporary directory: its record ``ok``, with its peak bytes a
     device, FLOPs, collective bytes and bottleneck (modelled from the
     data-sheet constants, not measured);
  14. the f32 smoke configurations (Qwen2.5-7B with TokenDance and with
     the prefix policy, Hymba-1.5B with its recompute fallback,
     Qwen2.5-14B, Qwen3-4B, Qwen2-72B, Gemma3-1B, Gemma3-12B, Grok-1,
     Arctic, MusicGen and Chameleon with TokenDance, Mamba2 with its
     recompute fallback) served on the
     card against the same engine on the CPU: greedy tokens and ledgers
     equal, logits within atol 1e-3;
  15. [restore] the storage walkthrough
     (``repro_torch.examples.compression_demo.walkthrough``) at Qwen2.5-7B
     full width (28 layers, bf16 weights, random from seed 0): 8 agents,
     private prefix 32, one 128-token shared block each (S 1056, nb 33),
     collective recovery, Master + 7 mirrors, then every mirror restored
     by the family kernel (ONE launch), the per-mirror kernel (7
     launches) and the dense torch path, bit-equal; counts zeroed just
     before and read just after. Then each restore kernel against its
     plain version on that family (and a bf16 copy of it), aligned and
     with shifted frames, with CUDA-event times of (a) the family
     kernel, (b) the 7 per-mirror launches summed and (c) the dense path.
     Then [restore gemma3-1b]: the same walkthrough at Gemma3-1B full
     width (26 layers, head dim 256, f32 recovery) at ``block_select``
     64 (private prefix 64, S 1088, nb 17: 2048 (token, 16-byte chunk)
     pairs a tile, past one 1024-thread block); and [restore shapes]:
     both kernels on seeded families at bt 64 / hd 256 (f32), bt 128 / hd
     128 (f32), bt 128 / hd 256 (bf16) and Gemma3-12B's heads (KV 8, hd
     256, bt 32, 12 of 48 layers; f32), exact against the plain version
     in aligned frames, timed;
  16. [mixed matmul] ``ops.mixed_matmul`` (f32 activations x a bf16
     weight, the f32 rounds' linear products) at every product shape of
     the benchmark's three cells (decode at the batch's rows, recovery's
     largest fresh and selected calls, lm_head at the batch's rows) and at
     edge shapes (one row, 17 rows, K and N off every tile), each against
     the plain product (TF32 off) and twice for the same bits, timed beside
     the parent's path (the weight cast to f32, then cuBLAS's f32 product)
     and its bound; inf and NaN in x as in the plain product; the max
     error against the float64 product at a decode and a recovery shape
     no more than 1.5 times the parent's path's; a Qwen2.5-7B decode
     step's 197 products back to back on their own weights (14.14 GB),
     by the kernel (its launches counted) and by the parent's path.
The line before the last is the kernel table as JSON; the last line is
the result as JSON.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12}             # f32 outside tensor cores
TF32_FLOPS = 495e12                             # dense tensor-core TF32
REPLACES = {
    "rope_align": "src/repro/kernels/rope_align.py:47",
    "block_diff": "src/repro/kernels/block_diff.py:43",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:130",
    # the backward of that kernel's function (no TPU kernel: XLA derives it
    # from gqa_attention, src/repro/models/layers.py:94)
    "flash_prefill_bwd": "src/repro/kernels/flash_prefill.py:130",
    "flash_prefill_paged": "src/repro/kernels/flash_prefill.py:272",
    "flash_decode_paged": "src/repro/kernels/flash_decode.py:231",
    "flash_decode": "src/repro/kernels/flash_decode.py:101",
    "fused_diff_restore": "src/repro/kernels/diff_restore.py:116",
    "fused_family_restore": "src/repro/kernels/diff_restore.py:190",
    # no TPU kernel: the JAX package's einsums of an f32 activation and a
    # bf16 weight go through XLA
    "mixed_matmul": "none (XLA einsum, src/repro/models/layers.py:211)",
}
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}
SOURCES.update(
    fused_diff_restore="src/repro_torch/kernels/csrc/diff_restore.cu",
    fused_family_restore="src/repro_torch/kernels/csrc/diff_restore.cu")
# kernel vs plain version on the same inputs: f32 results differ by
# summation order / FMA contraction; bf16 results by one or two bf16 ulps
# of rounding the same f32 value
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1.6e-2)}


def say(*a):
    print(*a, flush=True)


# ------------------------------------------------------------ measurement
class Timer:
    """Median CUDA-event time of one call, with the L2 cache evicted
    before every timed call (64 MB written; the card's L2 is 50 MB) and
    the device then held ~0.1 ms by a spin, so that the host has enqueued
    the call before its start event fires: a kernel's device time, not
    its wrapper's host time (which exceeds a short kernel's)."""

    SPIN = 200_000        # device cycles

    def __init__(self, dev):
        self.flush = torch.empty(16 * 2 ** 20, dtype=torch.float32,
                                 device=dev)

    def evict(self):
        self.flush.zero_()

    def __call__(self, fn, reps=15, warm=2):
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.evict()
            torch.cuda._sleep(self.SPIN)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    @staticmethod
    def host_us(fn, n=200):
        """Host time of one call in µs: n calls enqueued back to back,
        without waiting for the device (a wrapper's checks, allocations
        and launch)."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6


class ReadTimer(Timer):
    """A :class:`Timer` that evicts the L2 cache by reading its 64 MB, not
    by writing them: a write leaves up to the cache's 50 MB dirty, and the
    timed call pays their write-back to HBM as it streams its own bytes
    (+37 % on a 136 MB weight read at decode, the mixed product's)."""

    def evict(self):
        self.flush.sum()


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes, flops, dtype, split_tf32=False):
    """The least time in ms and what sets it. ``split_tf32``: an f32
    product may also run as three TF32 products on the tensor cores (the
    f32 prefill path's design), so the lower of the two rates counts."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype]
    if split_tf32 and dtype == torch.float32:
        t_f = min(t_f, 3 * flops / TF32_FLOPS)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def allowed_cols(q_pos, window, Sk, kv_len=None):
    """The (query, column) pairs a prefill call allows, counted."""
    lim = q_pos.long() + 1
    lim = torch.minimum(lim, torch.full_like(lim, Sk))
    if kv_len is not None:
        lim = torch.minimum(lim, kv_len.long()[:, None])
    lo = torch.clamp(q_pos.long() - window + 1, min=0)
    return torch.clamp(lim - lo, min=0).sum().item()


def prefill_times(timer, q, k, v, q_pos, window, kv_len=None, softcap=0.0):
    """CUDA-event times of ``ops.flash_attention``, its plain version and
    SDPA (GQA; ``is_causal`` for a plain causal prefill, else a boolean
    mask of the allowed pairs) on one call's inputs, and its bound: each
    input read once, the output written once, and the two products over
    the allowed pairs at the input type's peak. A capped call (``softcap``
    > 0) has no library time: SDPA has no soft cap."""
    from repro_torch.kernels import ops, ref

    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    causal = (Sq == Sk and kv_len is None and window >= Sk and torch.equal(
        q_pos, torch.arange(Sq, device=q.device,
                            dtype=torch.int32).expand(B, Sq)))
    if causal:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    else:
        cols = torch.arange(Sk, device=q.device)
        dl = q_pos.long()[:, :, None] - cols
        mask = (dl >= 0) & (dl < window)
        if kv_len is not None:
            mask &= cols[None, None] < kv_len.long()[:, None, None]
        mask = mask[:, None]

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
    n_bytes = nbytes(q, k, v, q_pos, kv_len) + nbytes(q)
    flops = 4 * hd * H * allowed_cols(q_pos, window, Sk, kv_len)
    bms, by = bound(n_bytes, flops, q.dtype, split_tf32=True)
    return dict(
        ms=timer(lambda: ops.flash_attention(q, k, v, q_pos=q_pos,
                                             window=window, kv_len=kv_len,
                                             softcap=softcap)),
        plain_ms=timer(lambda: ref.flash_attention_ref(
            q, k, v, q_pos=q_pos, window=window, kv_len=kv_len,
            softcap=softcap)),
        library_ms=None if softcap else timer(library), bound_ms=bms,
        bound_by=by,
        bound_cuda_core_ms=bound(n_bytes, flops, q.dtype)[0])


def sdpa_decode(q, k, v, mask):
    """SDPA (GQA, boolean mask [B, Sk]) of one query per sequence over
    dense K/V [B, Sk, KV, hd]: the decode kernels' library yardstick."""
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    m4 = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=m4,
                                                  enable_gqa=True)


def decode_times(timer, kernel, plain, library, n_bytes, flops, dtype):
    """CUDA-event times of a decode kernel, its plain version and the
    library call (None for a capped call: SDPA has no soft cap), its
    bound, and the host time of one wrapper call."""
    bms, by = bound(n_bytes, flops, dtype)
    return dict(ms=timer(kernel), plain_ms=timer(plain),
                library_ms=None if library is None else timer(library),
                bound_ms=bms, bound_by=by, host_us=timer.host_us(kernel))


def times_line(t):
    host = f", host {t['host_us']:.1f} us a call" if "host_us" in t else ""
    core = ""
    if t.get("bound_cuda_core_ms", t["bound_ms"]) != t["bound_ms"]:
        core = f" (CUDA cores {t['bound_cuda_core_ms']:.4f})"
    lib = ("none: SDPA has no softcap" if t["library_ms"] is None else
           f"{t['library_ms']:.4f}")
    return (f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, SDPA {lib}, "
            f"bound {t['bound_ms']:.4f} by {t['bound_by']}{core}{host})")


def check(name, got, want, dtype, equal_nan=False):
    """Max abs error of a kernel's result against its plain version; raises
    beyond the tolerance or on any non-finite value. ``equal_nan`` (only
    block_diff's NaN case): NaN where the plain version gives NaN, and
    nowhere else."""
    atol, rtol = TOL[dtype] if name != "block_diff" else (0.0, 0.0)
    got, want = got.float(), want.float()
    if equal_nan:
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            raise AssertionError(f"{name} ({dtype}): NaN at other cells than "
                                 f"the plain version's")
        got, want = got[~nan], want[~nan]
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name} ({dtype}) disagrees with its plain "
                             f"version: max abs err {err.max().item()}")
    return err.max().item()


# ------------------------------------------------------------- phase 1
def card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    say(f"[card] nvidia-smi: {smi}")
    say(f"[card] torch: {torch.cuda.get_device_name(0)}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}  "
        f"devices {torch.cuda.device_count()}")
    return smi


# ------------------------------------------------------------- phase 2
def build():
    from repro_torch.kernels import build as kb

    t0 = time.perf_counter()
    logs = kb.build_all()
    say(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                say(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------- phase 3
class Recorder:
    """Wraps the ops wrappers during the main path and keeps a clone of
    the inputs of each kernel's largest call (and, for attention, of the
    largest call with selected query positions). ``split`` sorts the
    ``flash_prefill`` launch count's increments by call: bf16, f32 fresh
    (every row a query: the prefill or a recovery's fresh layers) and f32
    selective (a recovery's selected rows)."""

    def __init__(self, ops):
        self.ops = ops
        self.kept = {}
        self.orig = {}
        self.split = {"bf16": 0, "f32 fresh": 0, "f32 selective": 0}
        self.rope_split = {"shared": 0, "per_request": 0}

    def _keep(self, key, size, args, kwargs):
        # ``size`` orders calls by their work, read from shapes only (no
        # device sync on the served path)
        if key not in self.kept or self.kept[key][0] < size:
            clone = lambda x: x.clone() if torch.is_tensor(x) else x  # noqa
            self.kept[key] = (size, [clone(a) for a in args],
                              {k: clone(v) for k, v in kwargs.items()})

    def __enter__(self):
        for name in ("rope_align", "block_diff", "flash_attention",
                     "flash_decode_paged", "flash_decode"):
            fn = getattr(self.ops, name)
            self.orig[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                key, size = _name, args[0].numel()
                if _name == "flash_attention":
                    size *= args[1].shape[1]
                    if args[0].shape[1] != args[1].shape[1]:
                        key = "flash_attention_selected"
                    elif args[0].dtype == torch.bfloat16:
                        # round 0's prefill of a bf16 model (recovery in
                        # later rounds runs in f32)
                        self._keep("flash_attention_bf16", size, args,
                                   kwargs)
                elif _name == "flash_decode_paged":
                    size = args[3].numel()        # pages in the table
                elif _name == "flash_decode":
                    size = args[1].numel()        # the dense cache
                elif _name == "rope_align" and args[0].dim() == 5:
                    # one delta row a request: the decode tails' call
                    key = "rope_align_per_request"
                self._keep(key, size, args, kwargs)
                if _name == "rope_align":
                    n0 = self.ops.LAUNCHES["rope_align"]
                    out = _fn(*args, **kwargs)
                    self.rope_split["shared" if key == _name else
                                    "per_request"] += \
                        self.ops.LAUNCHES["rope_align"] - n0
                    return out
                if _name != "flash_attention":
                    return _fn(*args, **kwargs)
                n0 = self.ops.LAUNCHES["flash_prefill"]
                out = _fn(*args, **kwargs)
                kind = ("bf16" if args[0].dtype == torch.bfloat16 else
                        "f32 fresh" if args[0].shape[1] == args[1].shape[1]
                        else "f32 selective")
                self.split[kind] += self.ops.LAUNCHES["flash_prefill"] - n0
                return out

            setattr(self.ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def restore_line(rs):
    """The counted restore work of one round's ledger."""
    if not rs:
        return "no restore"
    return (f"restore pages {rs['pool_pages']} of {rs['full_write_pages']} "
            f"unshared (incremental {rs['incremental']}, reused "
            f"{rs.get('pages_reused', 0)}, new span "
            f"{rs.get('new_span_pages', 0)}, cow {rs.get('cow_pages', 0)}, "
            f"grown {rs.get('grown_pages', 0)})")


def serve_phase(tag, engine, trace, ops):
    """Serve the trace with the launch counts zeroed just before and read
    just after; returns (stats, launches, the Recorder)."""
    with Recorder(ops) as rec:
        ops.reset_launches()
        t0 = time.perf_counter()
        stats = engine.serve(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        plain = dict(ops.PLAIN_CALLS)
    for st in stats:
        say(f"[{tag}] round {st.round_idx}: prompt {st.prompt_len}, round "
            f"{st.t_round * 1e3:.1f} ms (recover {st.t_recover * 1e3:.1f}, "
            f"restore {st.t_restore * 1e3:.3f}, decode "
            f"{st.t_decode * 1e3:.1f}, store {st.t_store * 1e3:.1f}), "
            f"{restore_line(st.reuse.get('restore'))}, persistent "
            f"{st.persistent_bytes} B")
    say(f"[{tag}] serve {wall:.2f} s; launches {launches}  plain-version "
        f"calls {plain}")
    assert not any(plain.values()), f"plain versions ran: {plain}"
    assert sum(rec.split.values()) == launches["flash_prefill"], rec.split
    return stats, launches, rec


def bit_equal(tag, stats, other, what):
    """Outputs, first-token logits and persistent bytes of two serves of
    one trace equal to the last bit, round by round."""
    for st, os_ in zip(stats, other):
        assert np.array_equal(os_.outputs, st.outputs), (tag, st.round_idx)
        assert np.array_equal(os_.first_logits, st.first_logits), \
            (tag, st.round_idx)
        assert os_.persistent_bytes == st.persistent_bytes, \
            (tag, st.round_idx)
    say(f"[{tag}] outputs, first-token logits and persistent bytes "
        f"bit-equal to {what} in all {len(other)} rounds")


def main_path(dev):
    from repro_torch.configs import get_config
    from repro_torch.core.collector import PagedPrivate
    from repro_torch.core.rounds import generate_trace
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine, TokenDancePolicy

    cfg = get_config("qwen2.5-7b")
    say(f"[main] {cfg.name}: {cfg.n_layers} of {cfg.n_layers} layers (no "
        f"depth cut), d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}"
        f", head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, ~{cfg.param_count() / 1e9:.2f} B "
        f"params")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    say(f"[main] init_params(seed 0) {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    trace = generate_trace("agent_society", 8, 3, cfg.vocab_size, seed=0,
                           jitter_hist=False)
    engine = ServingEngine(params, cfg, keep_logits=True)
    pol = engine.policy
    assert isinstance(pol, TokenDancePolicy) and pol.incremental and \
        pol.paged_history and pol.paged_attention, pol
    # the paged history round 2 hands to the collector (its last call of
    # the round; the first is the untimed warm-up of a new shape)
    captured = {}
    reuse = engine.collector.collective_reuse

    def spy(*args, **kw):
        priv = args[7] if len(args) > 7 else kw.get("priv")
        if engine.round_idx == 2 and isinstance(priv, PagedPrivate):
            captured["priv"] = priv
        return reuse(*args, **kw)

    engine.collector.collective_reuse = spy
    torch.cuda.reset_peak_memory_stats()
    stats, launches, rec = serve_phase("main", engine, trace, ops)
    kept = rec.kept
    say(f"[main] flash_prefill launches by call: {rec.split}; rope_align "
        f"launches by call: {rec.rope_split}")
    del engine.collector.collective_reuse     # the spy holds the engine
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for st in stats:
        rs = st.reuse.get("restore", {})
        comp = st.reuse.get("compression", {})
        assert st.outputs.shape == (8, engine.gen_len), st.outputs.shape
        assert ((st.outputs >= 0) & (st.outputs < cfg.vocab_size)).all()
        assert np.isfinite(st.first_logits).all(), st.round_idx
        assert st.first_logits.shape == (8, cfg.vocab_size)
        if st.round_idx:
            # shared blocks make the family compress from round 1 on
            # (round 0's prompts share nothing)
            assert comp["compression_ratio"] > 1.0, comp
            assert 0 < rs["pool_pages"] <= rs["full_write_pages"], rs
    r2 = stats[2].reuse["restore"]
    assert r2["incremental"] is True and r2["pages_reused"] > 0 and \
        r2["pool_pages"] < r2["full_write_pages"], r2
    say(f"[main] peak device memory {peak:.2f} GiB; round 2 restored "
        f"incrementally: {r2['pool_pages']} pages written, "
        f"{r2['pages_reused']} reused, of {r2['full_write_pages']} unshared")
    missing = [k for k in ("rope_align", "block_diff", "flash_prefill",
                           "flash_decode_paged", "mixed_matmul")
               if launches[k] == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    priv = captured["priv"]
    assert priv.fast_path_ok(), "round 2's paged history is not paged"
    del engine

    def same(tag, other):
        bit_equal(tag, stats, other, "the main path")

    # [full]: the same weights and trace, every family rebuilt each round
    engine = ServingEngine(params, cfg, TokenDancePolicy(incremental=False),
                           keep_logits=True)
    full, _, _ = serve_phase("full", engine, trace, ops)
    same("full", full)
    f2 = full[2].reuse["restore"]
    assert f2["incremental"] is False and f2["pool_pages"] > r2["pool_pages"]
    say(f"[full] round 2: {f2['pool_pages']} restore pages written in "
        f"{full[2].t_restore * 1e3:.3f} ms against the main path's "
        f"{r2['pool_pages']} in {stats[2].t_restore * 1e3:.3f} ms; round 1 "
        f"(both full): {full[1].t_restore * 1e3:.3f} / "
        f"{stats[1].t_restore * 1e3:.3f} ms")
    del engine

    # [dense]: the same weights and trace through the dense decode loop
    engine = ServingEngine(params, cfg, paged_decode=False, keep_logits=True)
    dense, dlaunches, drec = serve_phase("dense", engine, trace, ops)
    same("dense", dense)
    assert dlaunches["flash_decode"] > 0 and \
        dlaunches["flash_decode_paged"] == 0, dlaunches
    kept["flash_decode_dense"] = drec.kept["flash_decode"]
    del engine
    torch.cuda.empty_cache()
    # the weights, trace and rounds the serving-layer phases reuse
    qwen = dict(params=params, cfg=cfg, trace=trace, stats=stats)
    return launches, kept, priv, cfg.n_heads, rec.split, rec.rope_split, qwen


# ------------------------------------------------------------- phase 4
def store_times(timer, kernel, plain, n_bytes, flops, dtype):
    """CUDA-event times of a store-side kernel and its plain version, and
    its bound (no PyTorch call computes either function)."""
    bms, by = bound(n_bytes, flops, dtype)
    return dict(ms=timer(kernel), plain_ms=timer(plain), bound_ms=bms,
                bound_by=by, library_ms=None)


def store_line(t):
    return (f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} by {t['bound_by']}, "
            f"{t['bound_ms'] / t['ms']:.2f} of it)")


def kernels(dev, launches, kept, split, rope_split):
    from repro_torch.kernels import ops, ref

    timer = Timer(dev)
    rows = []

    # ---- rope_align -------------------------------------------------
    # the shared blocks' call (one delta row for every layer) and the
    # decode tails' (one delta row a request), each in both types
    assert sum(rope_split.values()) == launches["rope_align"], rope_split
    for key, call in (("rope_align", "shared"),
                      ("rope_align_per_request", "per_request")):
        _, (k, delta, theta), _ = kept[key]
        errs, times = {}, {}
        for dt in (torch.bfloat16, torch.float32):
            kk = k.to(dt)
            got = ops.rope_align(kk, delta, theta)
            errs[dt] = check("rope_align", got,
                             ref.rope_delta_ref(kk, delta, theta), dt)
            assert torch.equal(got, ops.rope_align(kk, delta, theta)), dt
            times[dt] = store_times(
                timer, lambda kk=kk: ops.rope_align(kk, delta, theta),
                lambda kk=kk: ref.rope_delta_ref(kk, delta, theta),
                2 * nbytes(kk) + nbytes(delta), 7 * kk.numel() // 2, dt)
            say(f"[kernel] rope_align, {call} call, k {list(k.shape)} by "
                f"delta {list(delta.shape)}, {dt}: {store_line(times[dt])}, "
                f"max abs err {errs[dt]:.3g}")
        rows.append(dict(
            name="rope_align", shape=list(k.shape), call=call,
            launches=rope_split[call] if call != "shared" else
            launches["rope_align"], launches_split=rope_split,
            max_abs_err=errs[k.dtype], max_abs_err_f32=errs[torch.float32],
            **times[k.dtype]))
    # edge: per-request deltas over 4 copies of the shared call's keys
    _, (k, delta, theta), _ = kept["rope_align"]
    kb = torch.stack([k] * 4)
    d2 = torch.randint(-700, 700, (4, k.shape[1]), device=dev,
                       dtype=torch.int32)
    check("rope_align", ops.rope_align(kb, d2, theta),
          ref.rope_delta_ref(kb, d2, theta), kb.dtype)

    # ---- block_diff -------------------------------------------------
    _, (ks, vs, master, bt), _ = kept["block_diff"]
    errs, times = {}, {}
    nb = -(-ks.shape[2] // bt)
    for dt in (torch.bfloat16, torch.float32):
        a, b = ks.to(dt), vs.to(dt)
        got = ops.block_diff(a, b, master, bt)
        errs[dt] = check("block_diff", got,
                         ref.block_diff_ref(a, b, master, bt), dt)
        assert torch.equal(got, ops.block_diff(a, b, master, bt)), dt
        times[dt] = store_times(
            timer, lambda a=a, b=b: ops.block_diff(a, b, master, bt),
            lambda a=a, b=b: ref.block_diff_ref(a, b, master, bt),
            nbytes(a, b) + 4 * a.shape[0] * nb, 3 * (a.numel() + b.numel()),
            dt)
        say(f"[kernel] block_diff, 2 x {list(ks.shape)}, Master {master}, "
            f"{dt}: {store_line(times[dt])}")
    same = ks[:3].clone()
    same[1:] = same[0]
    assert (ops.block_diff(same, same, 0, bt) == 0).all(), "zero diffs"
    alld = same.clone()
    alld[1:] += 1.0
    out = ops.block_diff(alld, same, 0, bt)
    assert (out[1:] > 0).all() and (out[0] == 0).all(), "all diffs"
    ragged = ks[:, :, : ks.shape[2] - 5].contiguous()
    rv = vs[:, :, : vs.shape[2] - 5].contiguous()
    check("block_diff", ops.block_diff(ragged, rv, master, bt),
          ref.block_diff_ref(ragged, rv, master, bt), ks.dtype)
    # edge: a NaN in one mirror's block 1, then in the Master's: NaN in
    # that cell (every member's), as jnp.max gives; the rest exact
    for n in (2, 0):
        nk, nv = ks[:3, :2].clone(), vs[:3, :2].clone()
        nv[n, 1, bt + 8, 1, 7] = float("nan")
        got = ops.block_diff(nk, nv, 0, bt)
        check("block_diff", got, ref.block_diff_ref(nk, nv, 0, bt), ks.dtype,
              equal_nan=True)
        assert int(torch.isnan(got).sum()) == (1 if n else 3), got
    # edge: a family of 16 (two chunks of members a thread), timed
    k16 = torch.cat([ks, ks.roll(1, dims=2)])
    v16 = torch.cat([vs, vs.roll(1, dims=2)])
    check("block_diff", ops.block_diff(k16, v16, master, bt),
          ref.block_diff_ref(k16, v16, master, bt), ks.dtype)
    t16 = store_times(timer, lambda: ops.block_diff(k16, v16, master, bt),
                      lambda: ref.block_diff_ref(k16, v16, master, bt),
                      nbytes(k16, v16) + 4 * 16 * nb,
                      3 * (k16.numel() + v16.numel()), ks.dtype)
    say(f"[kernel] block_diff, 2 x {list(k16.shape)}, {ks.dtype}: "
        f"{store_line(t16)}; NaN cells as the plain version's")
    del k16, v16
    rows.append(dict(
        name="block_diff", shape=list(ks.shape), max_abs_err=errs[ks.dtype],
        max_abs_err_f32=errs[torch.float32], **times[ks.dtype]))

    # ---- flash_prefill ----------------------------------------------
    def attn_case(key):
        _, (q, k, v), kw = kept[key]
        return q, k, v, kw["q_pos"], kw["window"], kw.get("kv_len")

    for key in ("flash_attention", "flash_attention_selected",
                "flash_attention_bf16"):
        q, k, v, q_pos, window, kv_len = attn_case(key)
        for dt in (torch.bfloat16, torch.float32):
            qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
            errs[(key, dt)] = check(
                "flash_prefill",
                ops.flash_attention(qq, kk, vv, q_pos=q_pos, window=window,
                                    kv_len=kv_len),
                ref.flash_attention_ref(qq, kk, vv, q_pos=q_pos,
                                        window=window, kv_len=kv_len), dt)
    # edge: a kv_len that cuts a tile, and a sliding window
    q, k, v, q_pos, window, _ = attn_case("flash_attention_selected")
    kl = torch.full((q.shape[0],), k.shape[1] - 45, device=dev,
                    dtype=torch.int32)
    for w in (window, 100):
        check("flash_prefill",
              ops.flash_attention(q, k, v, q_pos=q_pos, window=w, kv_len=kl),
              ref.flash_attention_ref(q, k, v, q_pos=q_pos, window=w,
                                      kv_len=kl), q.dtype)
    q, k, v, q_pos, window, kv_len = attn_case("flash_attention")
    B, Sq, H, hd = q.shape
    causal = bool(Sq == k.shape[1] and torch.equal(
        q_pos, torch.arange(Sq, device=dev, dtype=torch.int32).expand(B, Sq)))
    assert causal, "the largest main-path prefill call is a causal prefill"
    # the path's largest call (f32: recovery from round 1 on) in both
    # types, and round 0's bf16 prefill as the path gave it
    times = {dt: prefill_times(timer, q.to(dt), k.to(dt), v.to(dt), q_pos,
                               window, kv_len)
             for dt in (torch.float32, torch.bfloat16)}
    for dt, t in times.items():
        say(f"[kernel] flash_prefill at the main path's largest call, q "
            f"{list(q.shape)} over {k.shape[1]} rows, causal, {dt}: "
            f"{times_line(t)}, max abs err "
            f"{errs[('flash_attention', dt)]:.3g}")
    r0 = attn_case("flash_attention_bf16")
    t0 = prefill_times(timer, *r0)
    say(f"[kernel] flash_prefill at round 0's bf16 prefill, q "
        f"{list(r0[0].shape)} over {r0[1].shape[1]} rows: {times_line(t0)}, "
        f"max abs err {errs[('flash_attention_bf16', torch.bfloat16)]:.3g}")
    rows.append(dict(
        name="flash_prefill", shape=list(q.shape) + [k.shape[1]],
        call="fresh", launches_split=split,
        max_abs_err=errs[("flash_attention", q.dtype)],
        max_abs_err_selected=errs[("flash_attention_selected", q.dtype)],
        max_abs_err_f32=errs[("flash_attention", torch.float32)],
        **times[q.dtype]))
    # the recovery's selective call (f32, from round 1 on): round 2's
    q, k, v, q_pos, window, kv_len = attn_case("flash_attention_selected")
    assert q.dtype == torch.float32 and kv_len is None, q.dtype
    ts = prefill_times(timer, q, k, v, q_pos, window, kv_len)
    blocks = [torch.unique(r // 32).tolist() for r in q_pos]
    say(f"[kernel] flash_prefill at the recovery's selective call, q "
        f"{list(q.shape)} at the selected positions (blocks of 32 a row: "
        f"{blocks}) over {k.shape[1]} rows, {q.dtype}: {times_line(ts)}, max "
        f"abs err {errs[('flash_attention_selected', q.dtype)]:.3g}; "
        f"launches {split['f32 selective']} selective, "
        f"{split['f32 fresh']} f32 fresh, {split['bf16']} bf16 "
        f"({launches['flash_prefill']} in all)")
    rows.append(dict(
        name="flash_prefill", shape=list(q.shape) + [k.shape[1]],
        call="selective", launches=split["f32 selective"],
        launches_split=split,
        max_abs_err=errs[("flash_attention_selected", q.dtype)],
        max_abs_err_f32=errs[("flash_attention_selected", q.dtype)], **ts))

    # ---- flash_decode_paged -----------------------------------------
    _, args, kw = kept["flash_decode_paged"]
    q, pk, pv, pidx, span = args[:5]
    B, H, hd = q.shape
    bt, KV = pk.shape[1], pk.shape[2]
    nbt = pidx.shape[1]
    cols = int(span.long().sum().item())
    mask = (torch.arange(nbt * bt, device=dev)[None] < span[:, None])
    ptimes = {}
    # the path's call in both types (f32 from round 1 on, bf16 in round 0):
    # against the plain version, twice for the same bits, and timed
    for dt in (torch.bfloat16, torch.float32):
        a = [q.to(dt), pk.to(dt), pv.to(dt), pidx, span]
        got = ops.flash_decode_paged(*a)
        errs[dt] = check("flash_decode_paged", got,
                         ref.flash_decode_paged_ref(*a), dt)
        assert torch.equal(ops.flash_decode_paged(*a), got), \
            ("flash_decode_paged", dt, "two calls differ")
        kd = a[1][pidx.long()].reshape(B, nbt * bt, KV, hd)
        vd = a[2][pidx.long()].reshape(B, nbt * bt, KV, hd)
        ptimes[dt] = decode_times(
            timer, lambda a=a: ops.flash_decode_paged(*a),
            lambda a=a: ref.flash_decode_paged_ref(*a),
            sdpa_decode(a[0], kd, vd, mask),
            nbytes(a[0], pidx, span) + nbytes(a[0])
            + 2 * cols * KV * hd * a[1].element_size(),
            4 * hd * H * cols, dt)
        say(f"[kernel] flash_decode_paged at the main path's call, q "
            f"{list(q.shape)} over {nbt} pages of {bt}, span "
            f"{span.tolist()}, {dt}: {times_line(ptimes[dt])}, max abs err "
            f"{errs[dt]:.3g}; two calls bit-equal")
    # edges: ragged last pages (span not a page multiple), then a tail
    rag = torch.clamp(span - torch.arange(1, B + 1, device=dev,
                                          dtype=torch.int32) * 7, min=1)
    tk = torch.randn(B, 64, KV, hd, device=dev).to(q.dtype)
    tv = torch.randn(B, 64, KV, hd, device=dev).to(q.dtype)
    for extra in ((), (tk, tv, 45)):
        check("flash_decode_paged",
              ops.flash_decode_paged(q, pk, pv, pidx, rag, *extra),
              ref.flash_decode_paged_ref(q, pk, pv, pidx, rag, *extra),
              q.dtype)
    rows.append(dict(
        name="flash_decode_paged", shape=list(q.shape) + [nbt * bt],
        max_abs_err=errs[q.dtype], max_abs_err_f32=errs[torch.float32],
        **ptimes[q.dtype]))

    for r in rows:
        r.setdefault("launches", launches[r["name"]])
    return table_rows(rows)


def paged_prefill(dev, priv, H):
    """``flash_prefill_paged`` over the main path's round-2 history pool:
    one causal launch per layer (the path; counts zeroed before, read
    after), then the checks and times. Returns its kernel-table row."""
    from repro_torch.kernels import ops, ref

    L, P, bt, KV, hd = priv.pool_k.shape
    pidx = priv.page_idx.contiguous()
    B, nbh = pidx.shape
    span, T = priv.span_len, priv.tail_len
    S = span + T
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, S, H, hd, generator=g, device=dev)

    def layer(l, dt=None):
        x = (priv.pool_k[l], priv.pool_v[l],
             None if T == 0 else priv.tail_k[:, l].contiguous(),
             None if T == 0 else priv.tail_v[:, l].contiguous())
        return tuple(None if t is None else t.to(dt or t.dtype) for t in x)

    aliased = int(B * nbh - torch.unique(pidx).numel())
    say(f"[paged_prefill] round-2 history pool: {P} pages of {bt} over "
        f"{L} layers ({priv.pool_k.dtype}), {B} tables of {nbh} pages "
        f"({aliased} entries alias a page another entry holds), span "
        f"{span}, tails of {T}; q [{B},{S},{H},{hd}] from seed 2")
    ops.reset_launches()
    q = q.to(priv.pool_k.dtype)
    outs = [ops.flash_prefill_paged(q, pk, pv, pidx, tk, tv, span_len=span)
            for pk, pv, tk, tv in (layer(l) for l in range(L))]
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_prefill_paged"]
    plain = dict(ops.PLAIN_CALLS)
    say(f"[paged_prefill] launches {dict(ops.LAUNCHES)}  plain-version "
        f"calls {plain}")
    assert launches == L, launches
    assert not any(plain.values()), plain

    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    pos = pos.contiguous()
    # the same pages with the first half of every table aliasing table 0's
    # (the family case: clean mirror blocks on the Master's pages)
    alias = pidx.clone()
    alias[1:, : nbh // 2] = pidx[0, : nbh // 2]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        qq = q.to(dt)
        for case, cut, window, tab in (("aligned", 0, 0, pidx),
                                       ("ragged", 5, 0, pidx),
                                       ("window", 0, 100, pidx),
                                       ("aliased", 0, 0, alias)):
            sp, Sq = span - cut, S - cut
            qc = qq[:, :Sq].contiguous()
            worst = 0.0
            for l in range(L):
                pk, pv, tk, tv = layer(l, dt)
                got = ops.flash_prefill_paged(qc, pk, pv, tab, tk, tv,
                                              span_len=sp, window=window)
                if case == "aligned" and dt == priv.pool_k.dtype:
                    assert torch.equal(got, outs[l]), l
                kd, vd = ref.paged_kv_ref(pk, pv, tab, tk, tv, sp)
                dense = ops.flash_attention(
                    qc, kd.contiguous(), vd.contiguous(),
                    q_pos=pos[:, :Sq].contiguous(),
                    window=window or 2 ** 31 - 1)
                assert torch.equal(got, dense), (case, dt, l,
                                                 "paged != dense kernel")
                worst = max(worst, check(
                    "flash_prefill_paged", got, ref.flash_attention_paged_ref(
                        qc, pk, pv, tab, tk, tv, span_len=sp,
                        window=window), dt))
            errs[(case, dt)] = worst
            say(f"[paged_prefill] {case} (span {sp}, window "
                f"{window or 'none'}) {dt}: bit-equal to the dense kernel on "
                f"the gathered stream in all {L} layers, max abs err "
                f"{worst:.3g} against the plain version")

    # times at layer 0, f32 (the pool's dtype) and a bf16 copy
    timer = Timer(dev)
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        qq = q.to(dt)
        pk, pv, tk, tv = layer(0, dt)
        kd, vd = ref.paged_kv_ref(pk, pv, pidx, tk, tv, span)
        kd, vd = kd.contiguous(), vd.contiguous()
        qt, kt, vt = qq.transpose(1, 2), kd.transpose(1, 2), \
            vd.transpose(1, 2)
        # each input read once: q, the distinct pages the tables name, the
        # tails and the table; the output written once. Operations: the
        # two products over the allowed (query, column) pairs, causal
        pages = torch.unique(pidx).numel()
        n_bytes = (nbytes(qq, tk, tv, pidx) + nbytes(qq)
                   + 2 * pages * bt * KV * hd * pk.element_size())
        flops = 4 * hd * H * B * S * (S + 1) // 2
        bms, by = bound(n_bytes, flops, dt, split_tf32=True)
        t = [timer(f) for f in (
            lambda: ops.flash_prefill_paged(qq, pk, pv, pidx, tk, tv,
                                            span_len=span),
            lambda: ops.flash_attention(qq, kd, vd, q_pos=pos,
                                        window=2 ** 31 - 1),
            lambda: ops.flash_attention(qq, kd, vd, q_pos=pos,
                                        window=2 ** 31 - 1),
            lambda: ops.flash_prefill_paged(qq, pk, pv, pidx, tk, tv,
                                            span_len=span))]
        times[dt] = dict(
            ms=statistics.median((t[0], t[3])), dense=(t[1], t[2]),
            paged=(t[0], t[3]),
            plain_ms=timer(lambda: ref.flash_attention_paged_ref(
                qq, pk, pv, pidx, tk, tv, span_len=span)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            bound_ms=bms, bound_by=by,
            bound_cuda_core_ms=bound(n_bytes, flops, dt)[0])
        tm = times[dt]
        say(f"[kernel] flash_prefill_paged {dt}, q [{B},{S},{H},{hd}] over "
            f"{nbh} pages + {T} tail rows a sequence: paged "
            f"{tm['paged'][0]:.4f} / {tm['paged'][1]:.4f} ms, dense kernel "
            f"on the gathered rows {tm['dense'][0]:.4f} / "
            f"{tm['dense'][1]:.4f} ms (in turns paged, dense, dense, paged), "
            f"plain {tm['plain_ms']:.4f}, SDPA over the gathered rows "
            f"{tm['library_ms']:.4f}, bound {bms:.4f} by {by} (CUDA cores "
            f"{tm['bound_cuda_core_ms']:.4f})")
    dt = priv.pool_k.dtype
    tm = times[dt]
    return dict(
        name="flash_prefill_paged", shape=[B, S, H, hd, nbh, bt, T],
        max_abs_err=errs[("aligned", dt)],
        max_abs_err_f32=errs[("aligned", torch.float32)],
        ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
        bound_by=tm["bound_by"], library_ms=tm["library_ms"],
        bound_cuda_core_ms=tm["bound_cuda_core_ms"], launches=launches)


def table_rows(rows):
    """Print each kernel's line and return its entries of the kernel
    table (the JSON line)."""
    table = []
    for r in rows:
        r.update(route="cuda", source=SOURCES[r["name"]],
                 replaces=REPLACES[r["name"]])
        call = f" ({r['call']} call)" if "call" in r else ""
        say(f"[kernel] {r['name']}{call}: shape {r['shape']}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}), max abs err "
            f"{r['max_abs_err']:.3g} at the path's dtype / "
            f"{r['max_abs_err_f32']:.3g} in f32, "
            f"{r['launches']} launches on the main path")
        table.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "call", "launches_split", "bound_cuda_core_ms") if k in r})
    return table


# ------------------------------------------------------ serving layer
def prefix(dev, qwen):
    """[prefix]: the vLLM prefix-caching baseline on the main path's
    weights and trace (counts zeroed before, read after), then the
    kernel at round 2's extend call (the largest: every layer's has the
    same shape) against its plain version, in bf16 and f32, twice for the
    same bits, and timed. Returns its kernel-table row."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    params, cfg, trace, main = (qwen[k] for k in ("params", "cfg", "trace",
                                                  "stats"))
    n = len(trace.agent_ids)
    engine = ServingEngine(params, cfg, "prefix", keep_logits=True)
    kept, ext = {}, {"launches": 0}
    attend = ops.flash_attention

    def spy(q, k, v, **kw):
        # extend passes kv_len; a prefill does not
        if kw.get("kv_len") is None:
            return attend(q, k, v, **kw)
        if engine.round_idx == 2:
            kept["extend"] = ([x.clone() for x in (q, k, v)], {
                key: val.clone() if torch.is_tensor(val) else val
                for key, val in kw.items()})
        n0 = ops.LAUNCHES["flash_prefill"]
        out = attend(q, k, v, **kw)
        ext["launches"] += ops.LAUNCHES["flash_prefill"] - n0
        return out

    ops.flash_attention = spy
    try:
        stats, launches, rec = serve_phase("prefix", engine, trace, ops)
    finally:
        ops.flash_attention = attend
    for st, m in zip(stats, main):
        say(f"[prefix] round {st.round_idx}: prompt {st.prompt_len}, "
            f"prefix_len {st.reuse.get('prefix_len', 0)}, recover "
            f"{st.t_recover * 1e3:.1f} ms, decode {st.t_decode * 1e3:.1f}, "
            f"store {st.t_store * 1e3:.1f}; persistent "
            f"{st.persistent_bytes // n} B an agent (TokenDance main path "
            f"{m.persistent_bytes // n} B, "
            f"{m.persistent_bytes / st.persistent_bytes:.3f} of it)")
        assert st.outputs.shape == (n, engine.gen_len), st.outputs.shape
        assert np.isfinite(st.first_logits).all(), st.round_idx
        assert st.first_logits.shape == (n, cfg.vocab_size)
        assert st.prompt_len == m.prompt_len, (st.prompt_len, m.prompt_len)
    assert stats[1].reuse["prefix_len"] > 0 and \
        stats[2].reuse["prefix_len"] > 0, [s.reuse for s in stats]
    # round 0 recomputes under both policies: the same calls, the same bits
    assert np.array_equal(stats[0].outputs, main[0].outputs)
    assert np.array_equal(stats[0].first_logits, main[0].first_logits)
    missing = [k for k in ("flash_prefill", "flash_decode_paged")
               if launches[k] == 0]
    assert not missing and ext["launches"] > 0, (launches, ext)
    assert launches["rope_align"] == launches["block_diff"] == 0, launches
    ptrs = {t.untyped_storage().data_ptr() for s in engine.sessions.values()
            for t in (s.dense_k, s.dense_v)}
    assert len(ptrs) == 2 * n, "sessions share storage"
    say(f"[prefix] round 0 bit-equal to the main path's; flash_prefill "
        f"launches by call {rec.split}, of which extend {ext['launches']}; "
        f"{2 * n} session tensors, each of its own storage")
    del engine

    (q, k, v), kw = kept["extend"]
    q_pos, window, kv_len = kw["q_pos"], kw["window"], kw["kv_len"]
    assert q.shape[1] < k.shape[1] and q.dtype == torch.bfloat16, q.shape
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
        got = ops.flash_attention(qq, kk, vv, q_pos=q_pos, window=window,
                                  kv_len=kv_len)
        errs[dt] = check("flash_prefill", got, ref.flash_attention_ref(
            qq, kk, vv, q_pos=q_pos, window=window, kv_len=kv_len), dt)
        assert torch.equal(got, ops.flash_attention(
            qq, kk, vv, q_pos=q_pos, window=window, kv_len=kv_len)), \
            (dt, "two calls differ")
    t = prefill_times(Timer(dev), q, k, v, q_pos, window, kv_len)
    p0 = int(q_pos[0, 0].item())
    say(f"[kernel] flash_prefill at round 2's extend call, q "
        f"{list(q.shape)} at positions {p0}..{k.shape[1] - 1} over "
        f"{k.shape[1]} rows, kv_len {kv_len.tolist()}, {q.dtype}: "
        f"{times_line(t)}, max abs err {errs[torch.bfloat16]:.3g} (bf16) / "
        f"{errs[torch.float32]:.3g} (f32); two calls bit-equal")
    say(f"[prefix] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(name="flash_prefill", call="extend",
                shape=list(q.shape) + [k.shape[1]],
                launches=ext["launches"],
                launches_split={"extend": ext["launches"], **rec.split},
                max_abs_err=errs[q.dtype],
                max_abs_err_f32=errs[torch.float32], **t)


def slo(qwen):
    """[slo]: the default engine served under a ``RoundPlanner`` whose
    model is the main path's round 2 (8 agents, collective). A collective
    round's latency falls with the agent count at a fixed service time,
    so a load and an SLO alone admit all agents or none; the pool term
    makes the cap bind: the budget holds 4 agents' persistent state, and
    an agent past it pays a recompute round, modelled at twice the
    measured round. The load is one round a round time and the SLO 1.4
    round times, which admits 4. Each round must admit min(cap, 8)
    agents in the planner's round-robin order and leave every deferred
    agent's session as it was."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (RoundPlanner, ServingEngine,
                                     max_agents_under_slo,
                                     service_times_from_stats)
    from repro_torch.serving.scheduler import round_service_time

    t_phase = time.perf_counter()
    params, cfg, trace, main = (qwen[k] for k in ("params", "cfg", "trace",
                                                  "stats"))
    aids = list(trace.agent_ids)
    n = len(aids)
    b = round_service_time(service_times_from_stats(
        main[2], n, collective=True), n)
    measured = service_times_from_stats(main[2], n, collective=True,
                                        recompute_round=2 * b)
    budget = 4 * measured.persistent_per_agent
    qps, slo_s = 1.0 / b, 1.4 * b
    cap = max_agents_under_slo(lambda _: measured, qps, slo_s,
                               range(1, n + 1), budget)
    say(f"[slo] model: round 2 of the main path, service {b * 1e3:.1f} ms "
        f"a round, {measured.persistent_per_agent:.0f} B an agent; pool "
        f"budget {budget:.0f} B, qps {qps:.4f}, SLO {slo_s * 1e3:.1f} ms "
        f"-> cap {cap} of {n}")
    assert 1 < cap < n, cap
    planner = RoundPlanner(measure=lambda _: measured, qps=qps, slo_s=slo_s,
                           pool_budget_bytes=budget, refit_every=1)
    engine = ServingEngine(params, cfg, keep_logits=True)
    run_round = engine.run_round

    def snapshot(a):
        s = engine.sessions[a]
        out = engine.last_outputs.get(a)
        return (s.state.history.tobytes(), id(s.mirror), id(s.hist_entry),
                s.family, s.is_master, s.hist_pending,
                None if out is None else out.tobytes())

    def checked(rnd, plan=None, next_plan=None):
        before = {a: snapshot(a) for a in plan.deferred}
        st = run_round(rnd, plan, next_plan)
        for a, snap in before.items():
            assert snapshot(a) == snap, (st.round_idx, a, "deferred agent "
                                         "touched")
        return st

    engine.run_round = checked
    ops.reset_launches()
    t0 = time.perf_counter()
    stats = engine.serve(trace, planner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
    cursor = 0
    for st in stats:
        adm = st.admission
        k = min(adm["max_agents"], n)
        want = [aids[(cursor + i) % n] for i in range(k)]
        cursor = (cursor + k) % n
        say(f"[slo] round {st.round_idx}: cap {adm['max_agents']}, admitted "
            f"{adm['admitted']}, deferred {adm['deferred']}, prompt "
            f"{st.prompt_len}, round {st.t_round * 1e3:.1f} ms")
        assert adm["admitted"] == want, (st.round_idx, adm, want)
        assert adm["deferred"] == [a for a in aids if a not in want]
        assert st.n_agents == k and st.outputs.shape == (k, engine.gen_len)
        assert np.isfinite(st.first_logits).all(), st.round_idx
    assert stats[0].admission["max_agents"] == cap
    assert not any(plain.values()), f"plain versions ran: {plain}"
    say(f"[slo] serve {wall:.2f} s, refits {planner.refits}, launches "
        f"{launches}; every deferred agent's session untouched")
    say(f"[slo] phase {time.perf_counter() - t_phase:.1f} s")
    del engine.run_round          # the check holds the engine
    del engine


def continuous(qwen):
    """[continuous]: ``ContinuousEngine`` with the TokenDance policy on 6
    agents in committees of 2 (``generative_agents``, 3 rounds, seed 11,
    arrivals at ticks 0, 8, 16: ``benchmarks/capacity.py``'s
    continuous_serving) at full width, against the synchronized engine
    on the same topology: per-agent outputs and first-token logits
    bit-equal; counts zeroed before the continuous serve, read after."""
    from repro_torch.core.rounds import SubsetGather, generate_trace
    from repro_torch.kernels import ops
    from repro_torch.serving import ContinuousEngine, ServingEngine

    t_phase = time.perf_counter()
    params, cfg = qwen["params"], qwen["cfg"]
    aids = [f"agent{i}" for i in range(6)]
    kw = dict(topology=SubsetGather.grouped(aids, 2), gen_len=32,
              recompute_ratio=0.1, keep_logits=True)

    def trace():
        return generate_trace("generative_agents", 6, 3, cfg.vocab_size,
                              seed=11, jitter_hist=False)

    t0 = time.perf_counter()
    oracle = ServingEngine(params, cfg, **kw).serve(trace())
    torch.cuda.synchronize()
    t_sync = time.perf_counter() - t0
    cont = ContinuousEngine(params, cfg, "tokendance", **kw)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = cont.serve(trace(), stagger=[0, 8, 16])
    torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
    for r, st in enumerate(oracle):
        assert st.admission is None and st.outputs.shape == (6, 32)
        for i, a in enumerate(aids):
            assert np.array_equal(res.outputs[a][r], st.outputs[i]), (a, r)
            assert np.array_equal(res.logits[a][r], st.first_logits[i]), \
                (a, r)
        assert np.isfinite(st.first_logits).all(), r
    say(f"[continuous] prompts {[s.prompt_len for s in oracle]}; per-agent "
        f"outputs and first-token logits bit-equal to the synchronized "
        f"engine in all 3 rounds x 6 agents")
    say(f"[continuous] counted makespan {res.makespan_steps} steps against "
        f"{res.sync_makespan_steps} synchronized, overlap steps "
        f"{res.overlap_steps}, restore-overlap events "
        f"{res.restore_overlap_events}, timeline events "
        f"{len(res.timeline)}; wall {t_cont:.2f} s continuous, "
        f"{t_sync:.2f} s synchronized")
    say(f"[continuous] launches {launches}  plain-version calls {plain}")
    assert res.makespan_steps < res.sync_makespan_steps, res.makespan_steps
    assert res.overlap_steps > 0 and res.restore_overlap_events > 0
    missing = [k for k in ("rope_align", "block_diff", "flash_prefill",
                           "flash_decode_paged", "mixed_matmul")
               if launches[k] == 0]
    assert not missing, f"kernels never launched: {missing}"
    assert not any(plain.values()), f"plain versions ran: {plain}"
    cont.engine.manager.check()
    say(f"[continuous] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ [pages]
PAGE_CASES = ((16, 32), (64, 64))       # (block_select, gen_len)


def decode_row_times(timer, q, pk, pv, pidx, span):
    """CUDA-event times of ``flash_decode_paged`` on one call (no tail, no
    window, no cap), its plain version and SDPA over the gathered rows,
    and its bound: q, the table, the lengths and the output once, each
    span row's K and V once; 4 hd flops a row and query head."""
    from repro_torch.kernels import ops, ref

    B, H, hd = q.shape
    _, bt, KV, _ = pk.shape
    nbt = pidx.shape[1]
    kd = pk[pidx.long()].reshape(B, nbt * bt, KV, hd)
    vd = pv[pidx.long()].reshape(B, nbt * bt, KV, hd)
    mask = torch.arange(nbt * bt, device=q.device)[None] < span[:, None]
    cols = int(span.long().sum().item())
    t = decode_times(
        timer, lambda: ops.flash_decode_paged(q, pk, pv, pidx, span),
        lambda: ref.flash_decode_paged_ref(q, pk, pv, pidx, span),
        sdpa_decode(q, kd, vd, mask),
        nbytes(q, pidx, span) + nbytes(q)
        + 2 * cols * KV * hd * pk.element_size(), 4 * hd * H * cols,
        q.dtype)
    del kd, vd
    return t


def pages_phase(dev, qwen):
    """[pages]: the main path's weights and trace served by
    ``ServingEngine(params, cfg, block_select=16)`` (gen 32) and
    ``block_select=64, gen_len=64``, counts zeroed before and read after
    (every main-path kernel launched, no plain version), then again with
    ``paged_decode=False`` at the same block_select: outputs, first-token
    logits and persistent bytes bit-equal. The paged decode kernel is held
    at each run's largest call in bf16 and f32 (twice for the same bits)
    and timed in f32, the path's type from round 1. Returns the
    kernel-table rows."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    params, cfg, trace = qwen["params"], qwen["cfg"], qwen["trace"]
    timer = Timer(dev)
    rows = []
    for bs, gen in PAGE_CASES:
        tag = f"pages {bs}"
        kw = dict(block_select=bs, gen_len=gen, keep_logits=True)
        engine = ServingEngine(params, cfg, **kw)
        stats, launches, rec = serve_phase(tag, engine, trace, ops)
        del engine
        missing = [k for k in ("rope_align", "block_diff", "flash_prefill",
                               "flash_decode_paged", "mixed_matmul")
                   if launches[k] == 0]
        assert not missing, f"kernels never launched at {tag}: {missing}"
        for st in stats:
            assert st.prompt_len % bs == 0, (tag, st.prompt_len)
            assert st.outputs.shape == (8, gen), st.outputs.shape
            assert ((st.outputs >= 0) & (st.outputs < cfg.vocab_size)).all()
            assert np.isfinite(st.first_logits).all(), (tag, st.round_idx)
        engine = ServingEngine(params, cfg, paged_decode=False, **kw)
        dense, dl, drec = serve_phase(f"{tag} dense", engine, trace, ops)
        del engine, drec
        bit_equal(f"{tag} dense", stats, dense,
                  f"the paged loop's at block_select {bs}")
        assert dl["flash_decode"] > 0 and dl["flash_decode_paged"] == 0, dl

        _, args, _ = rec.kept["flash_decode_paged"]
        del rec
        q, pk, pv, pidx, span = args[:5]
        assert pk.shape[1] == bs, (tag, tuple(pk.shape))
        errs = {}
        for dt in (torch.bfloat16, torch.float32):
            a = [q.to(dt), pk.to(dt), pv.to(dt), pidx, span]
            got = ops.flash_decode_paged(*a)
            errs[dt] = check("flash_decode_paged", got,
                             ref.flash_decode_paged_ref(*a), dt)
            assert torch.equal(ops.flash_decode_paged(*a), got), \
                (tag, dt, "two calls differ")
        a = [q.float(), pk.float(), pv.float(), pidx, span]
        t = decode_row_times(timer, *a)
        say(f"[kernel] flash_decode_paged, {tag} call, q {list(q.shape)} "
            f"over {pidx.shape[1]} pages of {bs}, span {span.tolist()}, "
            f"f32: {times_line(t)}, max abs err {errs[torch.bfloat16]:.3g} "
            f"(bf16) / {errs[torch.float32]:.3g} (f32); two calls "
            f"bit-equal")
        rows.append(dict(
            name="flash_decode_paged", call=tag,
            shape=list(q.shape) + [pidx.shape[1] * bs],
            launches=launches["flash_decode_paged"],
            max_abs_err=errs[q.dtype], max_abs_err_f32=errs[torch.float32],
            **t))
        del a, args, q, pk, pv
        torch.cuda.empty_cache()
    say(f"[pages] phase {time.perf_counter() - t_phase:.1f} s")
    return rows


def page_edges(dev):
    """[page edges]: ``flash_decode_paged`` at pages of 16, 24, 32, 64 and
    128 rows over 576 positions (8 sequences, a span of 571: ragged by 5),
    at Qwen2.5-7B's heads (28 over 4, hd 128) and Gemma3-12B's (16 over 8,
    hd 256), in bf16 and f32: as it is, with a binding window of 100,
    capped at 30 and with a tail of 45 rows. Each call is held to its
    plain version, gives the same bits twice and equals the dense decode
    kernel on the rows gathered in position order bit for bit; the first
    is timed beside its plain version, SDPA over the gathered rows and its
    bound (these calls are on no path: lines, not kernel-table rows)."""
    from repro_torch.kernels import ops, ref

    t_phase = time.perf_counter()
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(27)
    B, R, Tp, span_len = 8, 576, 64, 571
    for H, KV, hd in ((28, 4, 128), (16, 8, 256)):
        for bt in (16, 24, 32, 64, 128):
            nbt = -(-R // bt)
            P = B * nbt + 7
            for dt in (torch.bfloat16, torch.float32):
                def rnd(*shape):
                    return torch.randn(*shape, generator=g,
                                       device=dev).to(dt)

                q, pk, pv = rnd(B, H, hd), rnd(P, bt, KV, hd), \
                    rnd(P, bt, KV, hd)
                tk, tv = rnd(B, Tp, KV, hd), rnd(B, Tp, KV, hd)
                pidx = torch.randperm(P, generator=g, device=dev)[
                    : B * nbt].reshape(B, nbt).to(torch.int32).contiguous()
                span = torch.full((B,), span_len, device=dev,
                                  dtype=torch.int32)
                gk = pk[pidx.long()].reshape(B, nbt * bt, KV, hd)
                gv = pv[pidx.long()].reshape(B, nbt * bt, KV, hd)
                errs = []
                for case, tail, kw in (("plain", (), {}),
                                       ("window 100", (), dict(window=100)),
                                       ("softcap 30", (), dict(softcap=30.0)),
                                       ("tail 45", (tk, tv, 45), {})):
                    got = ops.flash_decode_paged(q, pk, pv, pidx, span,
                                                 *tail, **kw)
                    errs.append(check("flash_decode_paged", got,
                                      ref.flash_decode_paged_ref(
                                          q, pk, pv, pidx, span, *tail,
                                          **kw), dt))
                    assert torch.equal(ops.flash_decode_paged(
                        q, pk, pv, pidx, span, *tail, **kw), got), \
                        (bt, hd, dt, case, "two calls differ")
                    tl = tail[2] if tail else 0
                    kd = torch.zeros(B, nbt * bt + Tp, KV, hd, device=dev,
                                     dtype=dt)
                    vd = torch.zeros_like(kd)
                    kd[:, :span_len], vd[:, :span_len] = \
                        gk[:, :span_len], gv[:, :span_len]
                    if tl:
                        kd[:, span_len:span_len + tl] = tk[:, :tl]
                        vd[:, span_len:span_len + tl] = tv[:, :tl]
                    dense = ops.flash_decode(
                        q, kd, vd, (span + tl).to(torch.int32),
                        kw.get("window", kd.shape[1]),
                        softcap=kw.get("softcap", 0.0))
                    assert torch.equal(dense, got), \
                        (bt, hd, dt, case, "paged != dense")
                    del kd, vd
                t = decode_row_times(timer, q, pk, pv, pidx, span)
                say(f"[page edges] flash_decode_paged, pages of {bt}, q "
                    f"{list(q.shape)} over {nbt} pages ({KV} KV heads), span "
                    f"{span_len}, {dt}: {times_line(t)}; plain / window / "
                    f"softcap / tail max abs err "
                    f"{' / '.join(f'{e:.3g}' for e in errs)}; twice and "
                    f"against the dense kernel bit-equal")
                del q, pk, pv, tk, tv, gk, gv
    torch.cuda.empty_cache()
    say(f"[page edges] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------- head layouts
#: public head layouts past the first kernels' limits: (model, query
#: heads, KV heads, head dim), one layer each at its published widths
HEAD_LAYOUTS = (
    ("Mistral-Large-2", 96, 8, 128),         # G 12
    ("Llama-3.1-405B", 128, 8, 128),         # G 16 over 8
    ("Qwen3-235B-A22B", 64, 4, 128),         # G 16 over 4
    ("Falcon-180B", 232, 8, 64),             # G 29
    ("Phi-2", 32, 32, 80),                   # head dim 80
    ("Phi-3-mini", 32, 32, 96),              # head dim 96
    ("MPT-30B", 64, 64, 112),                # head dim 112
)
#: the head layouts [train heads] and [train heads parity] train Qwen3-4B
#: with: (name, query heads, KV heads, head dim)
TRAIN_HEAD_LAYOUTS = (
    ("Phi-2", 32, 32, 80),
    ("Phi-3-mini", 32, 32, 96),
    ("hd 112 at G 4", 32, 8, 112),
)


def heads_decode(dev, timer, g, model, H, KV, hd):
    """The decode pair at one layout: 8 sequences over 576 positions in
    shuffled pages of 32, a span of 545 (the main path's), in bf16 and
    f32: as it is, with a binding window of 100, capped at 30 and with a
    tail of 45 rows. Each call against its plain version and twice
    bit-equal, and the dense kernel on the rows gathered in position order
    bit-equal to the paged one (and held to its own plain version). The
    plain calls timed beside their plain versions, SDPA and their bound."""
    from repro_torch.kernels import ops, ref

    B, R, Tp, span_len, bt = 8, 576, 64, 545, 32
    nbt = R // bt
    P = B * nbt + 7
    for dt in (torch.bfloat16, torch.float32):
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        q, pk, pv = rnd(B, H, hd), rnd(P, bt, KV, hd), rnd(P, bt, KV, hd)
        tk, tv = rnd(B, Tp, KV, hd), rnd(B, Tp, KV, hd)
        pidx = torch.randperm(P, generator=g, device=dev)[: B * nbt].reshape(
            B, nbt).to(torch.int32).contiguous()
        span = torch.full((B,), span_len, device=dev, dtype=torch.int32)
        gk = pk[pidx.long()].reshape(B, R, KV, hd)
        gv = pv[pidx.long()].reshape(B, R, KV, hd)
        errs = []
        for case, tail, kw in (("plain", (), {}),
                               ("window 100", (), dict(window=100)),
                               ("softcap 30", (), dict(softcap=30.0)),
                               ("tail 45", (tk, tv, 45), {})):
            got = ops.flash_decode_paged(q, pk, pv, pidx, span, *tail, **kw)
            errs.append(check("flash_decode_paged", got,
                              ref.flash_decode_paged_ref(
                                  q, pk, pv, pidx, span, *tail, **kw), dt))
            assert torch.equal(ops.flash_decode_paged(
                q, pk, pv, pidx, span, *tail, **kw), got), \
                (model, dt, case, "two calls differ")
            tl = tail[2] if tail else 0
            kd = torch.zeros(B, R + Tp, KV, hd, device=dev, dtype=dt)
            vd = torch.zeros_like(kd)
            kd[:, :span_len], vd[:, :span_len] = \
                gk[:, :span_len], gv[:, :span_len]
            if tl:
                kd[:, span_len:span_len + tl] = tk[:, :tl]
                vd[:, span_len:span_len + tl] = tv[:, :tl]
            kl = (span + tl).to(torch.int32)
            dargs = (q, kd, vd, kl, kw.get("window", R + Tp))
            dense = ops.flash_decode(*dargs, softcap=kw.get("softcap", 0.0))
            errs.append(check("flash_decode", dense, ref.flash_decode_ref(
                *dargs, softcap=kw.get("softcap", 0.0)), dt))
            assert torch.equal(dense, got), (model, dt, case,
                                             "paged != dense")
            assert torch.equal(ops.flash_decode(
                *dargs, softcap=kw.get("softcap", 0.0)), dense), \
                (model, dt, case, "two dense calls differ")
            del kd, vd
        tp = decode_row_times(timer, q, pk, pv, pidx, span)
        gk_, gv_ = gk.contiguous(), gv.contiguous()
        mask = torch.arange(R, device=dev)[None] < span[:, None]
        cols = int(span.long().sum().item())
        td = decode_times(
            timer, lambda: ops.flash_decode(q, gk_, gv_, span, R),
            lambda: ref.flash_decode_ref(q, gk_, gv_, span, R),
            sdpa_decode(q, gk_, gv_, mask),
            nbytes(q, span) + nbytes(q)
            + 2 * cols * KV * hd * q.element_size(), 4 * hd * H * cols, dt)
        say(f"[heads] {model} ({H} over {KV}, G {H // KV}, hd {hd}), {dt}: "
            f"flash_decode_paged over {nbt} pages of {bt}, span {span_len}: "
            f"{times_line(tp)}; flash_decode on the gathered rows: "
            f"{times_line(td)}; plain / window / softcap / tail max abs err "
            f"paged {' / '.join(f'{e:.3g}' for e in errs[0::2])}, dense "
            f"{' / '.join(f'{e:.3g}' for e in errs[1::2])}; twice and paged "
            f"== dense bit-equal")
        del q, pk, pv, tk, tv, gk, gv, gk_, gv_


def heads_prefill(dev, timer, g, model, H, KV, hd):
    """The prefill pair at one layout, in bf16 and f32: ``flash_attention``
    over 8 sequences of 544 (the recovery's fresh call) causal, with a
    binding window of 100 and a ragged kv_len, and capped at 30; and
    ``flash_prefill_paged`` over 7 pages of 32 and a 32-row tail (q [8,
    256]: the main path's round-2 pool) as it is, windowed and capped, each
    bit-equal to the dense kernel on the gathered rows. Each call against
    its plain version and twice bit-equal; the causal calls timed beside
    their plain versions, SDPA and their bound."""
    from repro_torch.kernels import ops, ref

    B, S = 8, 544
    nbh, bt, T = 7, 32, 32
    span = nbh * bt
    P = B * nbh + 3
    W = 2 ** 31 - 1
    for dt in (torch.bfloat16, torch.float32):
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        def twice(fn, what):
            got = fn()
            assert torch.equal(fn(), got), (model, dt, what,
                                            "two calls differ")
            return got

        q, k, v = rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)
        pos = torch.arange(S, device=dev, dtype=torch.int32).expand(
            B, S).contiguous()
        # every row keeps an allowed column under the window (a row with
        # none is undefined: each version averages what it visits)
        kl = torch.tensor([S, 500, 460, S, 445, S, 520, 480], device=dev,
                          dtype=torch.int32)
        errs = []
        for case, kw in (("causal", dict(window=S)),
                         ("window 100", dict(window=100, kv_len=kl)),
                         ("softcap 30", dict(window=S, softcap=30.0))):
            got = twice(lambda: ops.flash_attention(q, k, v, q_pos=pos, **kw),
                        f"flash_prefill {case}")
            errs.append(check("flash_prefill", got, ref.flash_attention_ref(
                q, k, v, q_pos=pos, **kw), dt))
        tf = prefill_times(timer, q, k, v, pos, S)

        qp = rnd(B, span + T, H, hd)
        pk, pv = rnd(P, bt, KV, hd), rnd(P, bt, KV, hd)
        tk, tv = rnd(B, T, KV, hd), rnd(B, T, KV, hd)
        pidx = torch.randperm(P, generator=g, device=dev)[: B * nbh].reshape(
            B, nbh).to(torch.int32).contiguous()
        kd = torch.cat([pk[pidx.long()].reshape(B, span, KV, hd), tk], 1)
        vd = torch.cat([pv[pidx.long()].reshape(B, span, KV, hd), tv], 1)
        ppos = torch.arange(span + T, device=dev, dtype=torch.int32).expand(
            B, span + T).contiguous()
        perrs = []
        for case, kw in (("causal", {}), ("window 100", dict(window=100)),
                         ("softcap 30", dict(softcap=30.0))):
            got = twice(lambda: ops.flash_prefill_paged(
                qp, pk, pv, pidx, tk, tv, span_len=span, **kw),
                f"flash_prefill_paged {case}")
            perrs.append(check("flash_prefill_paged", got,
                               ref.flash_attention_paged_ref(
                                   qp, pk, pv, pidx, tk, tv, span_len=span,
                                   **kw), dt))
            assert torch.equal(got, ops.flash_attention(
                qp, kd, vd, q_pos=ppos, window=kw.get("window") or W,
                softcap=kw.get("softcap", 0.0))), (model, dt, case,
                                                   "paged != dense")
        flops = 4 * hd * H * allowed_cols(ppos, W, span + T)
        n_bytes = (nbytes(qp, pidx, tk, tv) + nbytes(qp)
                   + 2 * B * span * KV * hd * qp.element_size())
        bms, by = bound(n_bytes, flops, dt, split_tf32=True)
        qt, kt, vt = (x.transpose(1, 2) for x in (qp, kd, vd))
        tp = dict(
            ms=timer(lambda: ops.flash_prefill_paged(
                qp, pk, pv, pidx, tk, tv, span_len=span)),
            plain_ms=timer(lambda: ref.flash_attention_paged_ref(
                qp, pk, pv, pidx, tk, tv, span_len=span)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            bound_ms=bms, bound_by=by,
            bound_cuda_core_ms=bound(n_bytes, flops, dt)[0])
        say(f"[heads] {model} ({H} over {KV}, hd {hd}), {dt}: flash_prefill "
            f"q {list(q.shape)} causal: {times_line(tf)}; causal / window / "
            f"softcap max abs err {' / '.join(f'{e:.3g}' for e in errs)}; "
            f"flash_prefill_paged q {list(qp.shape)} over {nbh} pages of "
            f"{bt} + {T} tail rows: {times_line(tp)}; causal / window / "
            f"softcap max abs err {' / '.join(f'{e:.3g}' for e in perrs)}, "
            f"each bit-equal to the dense kernel on the gathered rows; "
            f"every call twice bit-equal")
        del q, k, v, qp, pk, pv, tk, tv, kd, vd, qt, kt, vt


def heads_store(dev, timer, g, model, KV, hd):
    """``rope_align``, ``block_diff`` and the two restore kernels at one
    layer of a layout, in bf16 and f32: ``rope_align`` at the shared
    blocks' call (k [1, 544, KV, hd] by one delta row) and the decode
    tails' (k [8, 1, 32, KV, hd], one delta row a request); ``block_diff``
    over a family 2 x [8, 1, 544, KV, hd] in blocks of 32; the restores on
    a family of 7 mirrors over 17 blocks of 32 (``hold_restores``: exact in
    aligned frames). Each against its plain version and twice bit-equal,
    timed beside its plain version and bound (no library call computes
    these functions)."""
    from repro_torch.kernels import ops, ref

    theta = 1e4
    for dt in (torch.bfloat16, torch.float32):
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        parts = []
        for call, k, delta in (
                ("shared", rnd(1, 544, KV, hd),
                 torch.randint(-900, 900, (544,), generator=g, device=dev,
                               dtype=torch.int32)),
                ("per-request", rnd(8, 1, 32, KV, hd),
                 torch.randint(-900, 900, (8, 32), generator=g, device=dev,
                               dtype=torch.int32))):
            got = ops.rope_align(k, delta, theta)
            err = check("rope_align", got,
                        ref.rope_delta_ref(k, delta, theta), dt)
            assert torch.equal(got, ops.rope_align(k, delta, theta)), \
                (model, dt, call)
            t = store_times(
                timer, lambda k=k, d=delta: ops.rope_align(k, d, theta),
                lambda k=k, d=delta: ref.rope_delta_ref(k, d, theta),
                2 * nbytes(k) + nbytes(delta), 7 * k.numel() // 2, dt)
            parts.append(f"rope_align {call} k {list(k.shape)}: "
                         f"{store_line(t)}, max abs err {err:.3g}")
        ks, vs = rnd(8, 1, 544, KV, hd), rnd(8, 1, 544, KV, hd)
        ks[1, :, :64], vs[1, :, :64] = ks[4, :, :64], vs[4, :, :64]
        got = ops.block_diff(ks, vs, 4, 32)
        check("block_diff", got, ref.block_diff_ref(ks, vs, 4, 32), dt)
        assert torch.equal(got, ops.block_diff(ks, vs, 4, 32)), (model, dt)
        assert (got[4] == 0).all() and (got[1, :2] == 0).all(), got
        t = store_times(timer, lambda: ops.block_diff(ks, vs, 4, 32),
                        lambda: ref.block_diff_ref(ks, vs, 4, 32),
                        nbytes(ks, vs) + 4 * 8 * 17,
                        3 * (ks.numel() + vs.numel()), dt)
        parts.append(f"block_diff 2 x {list(ks.shape)}: {store_line(t)}, "
                     f"exact")
        say(f"[heads] {model} (KV {KV}, hd {hd}), {dt}: "
            + "; ".join(parts) + "; every call twice bit-equal")
        del ks, vs
    r = np.random.default_rng(hd)
    M, L, S, bt = 7, 1, 544, 32
    nb = S // bt
    ndb = nb // 3
    mk, mv = (torch.randn(L, S, KV, hd, generator=g, device=dev)
              for _ in range(2))
    dk, dv = (torch.randn(M, L, ndb, bt, KV, hd, generator=g, device=dev)
              for _ in range(2))
    slot = np.full((M, nb), -1, np.int32)
    for m in range(M):
        slot[m, r.choice(nb, ndb, replace=False)] = np.arange(ndb)
    maps = r.permutation(M * nb).reshape(M, nb).astype(np.int32)
    packs = {"aligned": (dk, dv, slot, np.zeros((M, nb, bt), np.int32)),
             "shifted": (dk, dv, slot, r.integers(1, 2000, (M, nb, bt)
                                                  ).astype(np.int32))}
    hold_restores("heads", dev, timer, mk, mv, packs, maps, theta,
                  (torch.float32, torch.bfloat16),
                  what=f"{model} (KV {KV}, hd {hd}) restores, M {M}, {L} "
                       f"layer, nb {nb}, ")


def heads_bwd(dev, timer, g, model, H, KV, hd):
    """The attention backward at one training layer of a layout, q [1,
    4096, H, hd] and k/v [1, 4096, KV, hd] (the ``train_4k`` length), in
    bf16 and f32: causal (timed beside its plain version, its bound and
    SDPA's backward, fwd + bwd - fwd), capped at 30 with q scaled by 8,
    and with a binding window of 1024 and kv_len 4000; each call against
    its plain version and twice bit-equal (``bwd_case``)."""
    S = 4096
    for dt in (torch.bfloat16, torch.float32):
        e, args = bwd_case(dev, g, dt, 1, S, S, H, KV, hd)
        q, k, v, out, dout, kw = args
        t = bwd_times(timer, q, k, v, out, dout, **kw)
        del q, k, v, out, dout, args
        ec, _ = bwd_case(dev, g, dt, 1, S, S, H, KV, hd, softcap=30.0,
                         qs=8.0)
        ew, _ = bwd_case(dev, g, dt, 1, S, S, H, KV, hd, window=1024,
                         kv_len=[4000])
        errs = [" / ".join(f"{x:.3g}" for x in y) for y in (e, ec, ew)]
        say(f"[heads] {model} ({H} over {KV}, hd {hd}), {dt}: "
            f"flash_prefill_bwd q [1, {S}, {H}, {hd}] causal: {times_line(t)}"
            f"; {t['achieved_tflops']:.1f} TFLOP/s of the bound's products; "
            f"max abs err dq / dk / dv causal {errs[0]}, softcap 30 "
            f"{errs[1]}, window 1024 kv_len 4000 {errs[2]}; every call "
            f"twice bit-equal")
        torch.cuda.empty_cache()


def heads_phase(dev):
    """[heads]: the kernels at the attention shapes of one layer of each
    public layout in ``HEAD_LAYOUTS`` (8 sequences, a span of 545): the
    decode pair at every layout (G 12, 16 over 8 and over 4, 29; head dims
    80, 96 and 112), and at head dims 80, 96 and 112 also the prefill
    pair, ``rope_align``, ``block_diff`` and both restores; then the
    attention backward at one training layer of each of
    ``TRAIN_HEAD_LAYOUTS``. Lines, not kernel-table rows: no served path
    makes these calls at these widths."""
    t_phase = time.perf_counter()
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(28)
    for model, H, KV, hd in HEAD_LAYOUTS:
        heads_decode(dev, timer, g, model, H, KV, hd)
        if hd in (80, 96, 112):
            heads_prefill(dev, timer, g, model, H, KV, hd)
            heads_store(dev, timer, g, model, KV, hd)
        torch.cuda.empty_cache()
    for model, H, KV, hd in TRAIN_HEAD_LAYOUTS:
        heads_bwd(dev, timer, g, model, H, KV, hd)
    say(f"[heads] phase {time.perf_counter() - t_phase:.1f} s")


#: [serve 112]: the main path's Qwen2.5-7B at full width with its heads
#: replaced by 32 over 4 at head dim 112
SERVE_112 = dict(n_heads=32, n_kv_heads=4, head_dim=112)

#: [heads serve]: the smoke Qwen2.5-7B with its heads replaced
HEADS_SERVE = (dict(n_heads=16, n_kv_heads=1, head_dim=96),
               dict(n_heads=8, n_kv_heads=2, head_dim=80))


def heads_serve(dev):
    """[heads serve]: ``ServingEngine(params, cfg)`` with its defaults
    (TokenDance, paged decode, incremental restore) on the 8-agent
    ``agent_society`` trace for 3 rounds (the main path's), at the smoke
    Qwen2.5-7B config with its heads replaced by ``HEADS_SERVE`` (G 16 at
    head dim 96; G 4 at head dim 80; weights random from seed 0): no
    registered config has these layouts. Counts zeroed before and read
    after: every main-path kernel launched, no plain version. Each again
    with ``paged_decode=False``: outputs, first-token logits and
    persistent bytes bit-equal, ``flash_decode`` launched instead."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.rounds import generate_trace
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    for heads in HEADS_SERVE:
        cfg = get_smoke_config("qwen2.5-7b").replace(**heads)
        hd, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
        tag = f"heads serve G {G} hd {hd}"
        say(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim {hd}, "
            f"{cfg.dtype}")
        params = init_params(cfg, 0, device=dev)
        trace = generate_trace("agent_society", 8, 3, cfg.vocab_size,
                               seed=0, jitter_hist=False)
        engine = ServingEngine(params, cfg, keep_logits=True)
        stats, launches, _ = serve_phase(tag, engine, trace, ops)
        del engine
        missing = [k for k in ("rope_align", "block_diff", "flash_prefill",
                               "flash_decode_paged", "mixed_matmul")
                   if launches[k] == 0]
        assert not missing, f"kernels never launched at {tag}: {missing}"
        for st in stats:
            assert st.outputs.shape == (8, 32), st.outputs.shape
            assert ((st.outputs >= 0) & (st.outputs < cfg.vocab_size)).all()
            assert np.isfinite(st.first_logits).all(), (tag, st.round_idx)
        assert stats[2].reuse["restore"]["incremental"], stats[2].reuse
        engine = ServingEngine(params, cfg, paged_decode=False,
                               keep_logits=True)
        dense, dl, _ = serve_phase(f"{tag} dense", engine, trace, ops)
        del engine
        bit_equal(f"{tag} dense", stats, dense, "the paged loop's")
        assert dl["flash_decode"] > 0 and dl["flash_decode_paged"] == 0, dl
        del params
    torch.cuda.empty_cache()
    say(f"[heads serve] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------- the Qwen and Gemma3 families
def gib(n_bytes):
    return n_bytes / 2 ** 30


def tensors(tree):
    """The tensors of a nested dict of parameters."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    return [tree]


def freed(tag, before, weights):
    """After ``del`` of a phase's engines and weights, and before any
    collector run: the allocated bytes, which must have dropped by the
    weights' size (no reference cycle keeps them)."""
    torch.cuda.synchronize()
    now = torch.cuda.memory_allocated()
    say(f"[{tag}] after del: {gib(now):.2f} GiB allocated (was "
        f"{gib(before):.2f} with the weights, {gib(weights):.2f} GiB of "
        f"them), no gc.collect()")
    assert before - now >= 0.99 * weights, (tag, before, now, weights)
    torch.cuda.empty_cache()


def forward_phase(dev, qwen):
    """[forward]: ``transformer.forward`` on the main path's Qwen2.5-7B
    weights over tokens [8, 544] from a seeded generator (counts zeroed
    before, read after): one ``flash_prefill`` launch a layer and no plain
    version; its logits bit-equal to ``prefill(max_len=544)``'s and the
    ``return_hidden`` state the pre-norm one they are read from; timed
    with CUDA events."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward, prefill
    from repro_torch.models.transformer import logits_of

    t_phase = time.perf_counter()
    params, cfg = qwen["params"], qwen["cfg"]
    B, S = 8, 544
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    ops.reset_launches()
    logits, aux = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
    say(f"[forward] {cfg.name}, tokens [{B}, {S}] from seed 0: launches "
        f"{launches}  plain-version calls {plain}")
    assert launches["flash_prefill"] == cfg.n_layers, launches
    assert sum(launches.values()) == cfg.n_layers, launches
    assert not any(plain.values()), f"plain versions ran: {plain}"
    assert logits.shape == (B, S, cfg.vocab_size), logits.shape
    assert logits.dtype == torch.float32 and bool(logits.isfinite().all())
    assert aux.shape == () and float(aux) == 0.0, aux
    pl, _ = prefill(params, cfg, tokens, max_len=S)
    assert torch.equal(logits, pl), "forward != prefill(max_len=S)"
    del pl
    hidden, _ = forward(params, cfg, tokens, return_hidden=True)
    assert hidden.shape == (B, S, cfg.d_model), hidden.shape
    assert torch.equal(logits_of(params, cfg, hidden), logits), \
        "return_hidden is not the state the logits are read from"
    del hidden, logits
    ms = Timer(dev)(lambda: forward(params, cfg, tokens), reps=5, warm=1)
    say(f"[forward] logits bit-equal to prefill(max_len={S})'s; "
        f"return_hidden gives the pre-norm hidden state; forward "
        f"{ms:.2f} ms (CUDA events, median of 5)")
    say(f"[forward] phase {time.perf_counter() - t_phase:.1f} s")


def serve_model(dev, arch, n_layers=None, engine_kw=None, heads=None,
                tag=None):
    """One config at its published widths (``n_layers`` cuts the depth;
    ``heads`` replaces its head layout, under the phase's ``tag``), bf16
    weights random from seed 0, served by ``ServingEngine(params, cfg)``
    with its defaults (and ``engine_kw``) on the main path's trace; counts
    zeroed before and read after. Each round says whether a sliding
    window binds at its cache length (prompt + generation). Returns the
    weights, the stats, the launches, the Recorder and the rounds whose
    window binds."""
    from repro_torch.configs import get_config
    from repro_torch.core.rounds import generate_trace
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_config(arch).replace(**(heads or {}))
    tag = tag or cfg.name
    full = cfg.n_layers
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    cut = (f"{cfg.n_layers} of {full} layers (depth cut: "
           f"~{get_config(arch).param_count() / 1e9:.1f} B params in all)"
           if cfg.n_layers < full else
           f"{cfg.n_layers} of {full} layers (no depth cut)")
    say(f"[{tag}] {cut}, d {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} (G {cfg.n_heads // cfg.n_kv_heads}), head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        f", qk_norm {cfg.qk_norm}, attn_bias {cfg.attn_bias}, tied "
        f"embeddings {cfg.tie_embeddings}, experts "
        f"{cfg.n_experts or 'none'} (top {cfg.top_k}, capacity factor "
        f"{cfg.capacity_factor}, dense residual {cfg.dense_residual}), "
        f"logit softcap {cfg.attn_logit_softcap or 'none'}, frontend "
        f"{cfg.frontend}, window "
        f"{cfg.sliding_window or 'none'} (every "
        f"{cfg.global_layer_interval or '-'}th layer global), "
        f"{cfg.dtype}, ~{cfg.param_count() / 1e9:.2f} B params served")
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    say(f"[{tag}] init_params(seed 0) {time.perf_counter() - t0:.1f} s, "
        f"weights {gib(weights):.2f} GiB")
    trace = generate_trace("agent_society", 8, 3, cfg.vocab_size, seed=0,
                           jitter_hist=False)
    engine = ServingEngine(params, cfg, keep_logits=True, **(engine_kw or {}))
    torch.cuda.reset_peak_memory_stats()
    stats, launches, rec = serve_phase(tag, engine, trace, ops)
    peak = torch.cuda.max_memory_allocated()
    assert peak < torch.cuda.get_device_properties(0).total_memory
    n = len(trace.agent_ids)
    binds = []
    for st in stats:
        comp = st.reuse.get("compression", {})
        rows = st.prompt_len + engine.gen_len
        if min(cfg.layer_window_sizes(rows)) < rows:
            binds.append(st.round_idx)
        say(f"[{tag}] round {st.round_idx}: persistent "
            f"{st.persistent_bytes // n} B an agent, compression "
            f"{comp.get('compression_ratio', 1.0):.4f}x, "
            f"{restore_line(st.reuse.get('restore'))}, window "
            f"{'binds' if st.round_idx in binds else 'does not bind'} at "
            f"{rows} rows")
        assert st.outputs.shape == (n, engine.gen_len), st.outputs.shape
        assert ((st.outputs >= 0) & (st.outputs < cfg.vocab_size)).all()
        assert np.isfinite(st.first_logits).all(), st.round_idx
        assert st.first_logits.shape == (n, cfg.vocab_size)
        if st.round_idx:
            assert comp["compression_ratio"] > 1.0, comp
    r2 = stats[2].reuse["restore"]
    assert r2["incremental"] is True and r2["pool_pages"] < \
        r2["full_write_pages"], r2
    missing = [k for k in ("rope_align", "block_diff", "flash_prefill",
                           "flash_decode_paged") if launches[k] == 0]
    assert not missing, f"kernels never launched on {tag}'s path: {missing}"
    say(f"[{tag}] flash_prefill launches by call: {rec.split}; rope_align "
        f"by call: {rec.rope_split}; peak device memory {gib(peak):.2f} "
        f"GiB (weights {gib(weights):.2f}) of the card's "
        f"{gib(torch.cuda.get_device_properties(0).total_memory):.2f}")
    del engine
    return dict(params=params, cfg=cfg, trace=trace, stats=stats,
                launches=launches, rec=rec, peak=peak, weights=weights,
                before=before + weights, binds=binds)


def hold_kernels(tag, dev, served, timed):
    """Each kernel of the path against its plain version on the inputs of
    its largest call in ``served``'s run (and round 0's bf16 prefill, the
    recovery's selective call and the decode tails' alignment), in bf16
    and f32; the decode kernel and the store-side pair twice for the same
    bits. ``timed``: CUDA-event times, bound and SDPA of the f32 calls
    (the path's type from round 1) as kernel-table rows."""
    from repro_torch.kernels import ops, ref

    kept, launches = served["rec"].kept, served["launches"]
    split, rope_split = served["rec"].split, served["rec"].rope_split
    timer = Timer(dev) if timed else None
    rows, errs = [], {}

    def both(name, fn, plain, args, twice=False):
        for dt in (torch.bfloat16, torch.float32):
            a = [x.to(dt) if torch.is_tensor(x) and x.is_floating_point()
                 else x for x in args]
            got = fn(*a)
            errs[(name, dt)] = check(name.split(":")[0], got, plain(*a), dt)
            if twice:
                assert torch.equal(fn(*a), got), (tag, name, dt,
                                                  "two calls differ")

    def attn(key):
        _, (q, k, v), kw = kept[key]
        return (q, k, v, kw["q_pos"], kw["window"], kw.get("kv_len"),
                kw.get("softcap", 0.0))

    cap = served["cfg"].attn_logit_softcap
    for key, call in (("flash_attention", "fresh"),
                      ("flash_attention_selected", "selective"),
                      ("flash_attention_bf16", "round 0")):
        if key not in kept:       # no selective layer under check_layer
            assert served["cfg"].n_layers <= 2, (tag, key)
            continue
        q, k, v, q_pos, window, kv_len, softcap = attn(key)
        # the path's calls carry the config's cap (the capped instance)
        assert softcap == cap, (tag, key, softcap, cap)
        both(f"flash_prefill:{call}",
             lambda q, k, v: ops.flash_attention(q, k, v, q_pos=q_pos,
                                                 window=window,
                                                 kv_len=kv_len,
                                                 softcap=softcap),
             lambda q, k, v: ref.flash_attention_ref(
                 q, k, v, q_pos=q_pos, window=window, kv_len=kv_len,
                 softcap=softcap),
             (q, k, v), twice=True)
        capped = f" capped at {softcap}" if softcap else ""
        say(f"[{tag}] flash_prefill {call}{capped}: q {list(q.shape)} over "
            f"{k.shape[1]} rows ({q.dtype} on the path), max abs err "
            f"{errs[(f'flash_prefill:{call}', torch.bfloat16)]:.3g} (bf16) / "
            f"{errs[(f'flash_prefill:{call}', torch.float32)]:.3g} (f32)")
        if timed:
            # recovery's calls in f32 (the path's type from round 1), round
            # 0's prefill in the model's type
            dt = q.dtype if call == "round 0" else torch.float32
            t = prefill_times(timer, q.to(dt), k.to(dt), v.to(dt), q_pos,
                              window, kv_len, softcap)
            say(f"[kernel] flash_prefill, {tag} {call} call, {dt}: "
                f"{times_line(t)}")
            rows.append(dict(
                name="flash_prefill", call=f"{tag} {call}",
                shape=list(q.shape) + [k.shape[1]],
                launches=split["bf16" if call == "round 0" else
                               "f32 fresh" if call == "fresh" else
                               "f32 selective"], launches_split=split,
                max_abs_err=errs[(f"flash_prefill:{call}", q.dtype)],
                max_abs_err_f32=errs[(f"flash_prefill:{call}",
                                      torch.float32)], **t))

    _, args, kw = kept["flash_decode_paged"]
    q, pk, pv, pidx, span = args[:5]
    dkw = dict(window=kw.get("window", 0), softcap=kw.get("softcap", 0.0))
    assert dkw["softcap"] == cap, (tag, dkw, cap)
    both("flash_decode_paged",
         lambda *a: ops.flash_decode_paged(*a, **dkw),
         lambda *a: ref.flash_decode_paged_ref(*a, **dkw),
         (q, pk, pv, pidx, span), twice=True)
    B, H, hd = q.shape
    bt, KV = pk.shape[1], pk.shape[2]
    nbt = pidx.shape[1]
    say(f"[{tag}] flash_decode_paged: q {list(q.shape)} (G {H // KV}) over "
        f"{nbt} pages of {bt}, span {span.tolist()}"
        f"{f', capped at {cap}' if cap else ''}, max abs err "
        f"{errs[('flash_decode_paged', torch.bfloat16)]:.3g} (bf16) / "
        f"{errs[('flash_decode_paged', torch.float32)]:.3g} (f32); two "
        f"calls bit-equal")
    if timed:
        a = [q.float(), pk.float(), pv.float(), pidx, span]
        cols = int(span.long().sum().item())
        mask = torch.arange(nbt * bt, device=dev)[None] < span[:, None]
        kd = a[1][pidx.long()].reshape(B, nbt * bt, KV, hd)
        vd = a[2][pidx.long()].reshape(B, nbt * bt, KV, hd)
        t = decode_times(
            timer, lambda: ops.flash_decode_paged(*a, **dkw),
            lambda: ref.flash_decode_paged_ref(*a, **dkw),
            None if cap else sdpa_decode(a[0], kd, vd, mask),
            nbytes(a[0], pidx, span) + nbytes(a[0])
            + 2 * cols * KV * hd * 4, 4 * hd * H * cols, torch.float32)
        del kd, vd
        say(f"[kernel] flash_decode_paged, {tag} call, f32: "
            f"{times_line(t)}")
        rows.append(dict(
            name="flash_decode_paged", call=tag,
            shape=list(q.shape) + [nbt * bt],
            launches=launches["flash_decode_paged"],
            max_abs_err=errs[("flash_decode_paged", q.dtype)],
            max_abs_err_f32=errs[("flash_decode_paged", torch.float32)],
            **t))

    for key in ("rope_align", "rope_align_per_request"):
        if key not in kept:
            continue
        _, (k, delta, theta), _ = kept[key]
        both(f"rope_align:{key}", lambda k: ops.rope_align(k, delta, theta),
             lambda k: ref.rope_delta_ref(k, delta, theta), (k,),
             twice=True)
        say(f"[{tag}] {key}: k {list(k.shape)} by delta "
            f"{list(delta.shape)}, max abs err "
            f"{errs[(f'rope_align:{key}', torch.bfloat16)]:.3g} (bf16) / "
            f"{errs[(f'rope_align:{key}', torch.float32)]:.3g} (f32)")
        if timed and key == "rope_align":
            kk = k.float()
            t = store_times(timer, lambda: ops.rope_align(kk, delta, theta),
                            lambda: ref.rope_delta_ref(kk, delta, theta),
                            2 * nbytes(kk) + nbytes(delta),
                            7 * kk.numel() // 2, torch.float32)
            say(f"[kernel] rope_align, {tag} shared call, f32: "
                f"{store_line(t)}")
            rows.append(dict(
                name="rope_align", call=f"{tag} shared",
                shape=list(k.shape), launches=rope_split["shared"],
                launches_split=rope_split,
                max_abs_err=errs[(f"rope_align:{key}", k.dtype)],
                max_abs_err_f32=errs[(f"rope_align:{key}", torch.float32)],
                **t))

    _, (ks, vs, master, bt), _ = kept["block_diff"]
    both("block_diff", lambda a, b: ops.block_diff(a, b, master, bt),
         lambda a, b: ref.block_diff_ref(a, b, master, bt), (ks, vs),
         twice=True)
    say(f"[{tag}] block_diff: 2 x {list(ks.shape)}, Master {master}, "
        f"exact in bf16 and f32, two calls bit-equal")
    if timed:
        a, b = ks.float(), vs.float()
        nb = -(-a.shape[2] // bt)
        t = store_times(timer, lambda: ops.block_diff(a, b, master, bt),
                        lambda: ref.block_diff_ref(a, b, master, bt),
                        nbytes(a, b) + 4 * a.shape[0] * nb,
                        3 * (a.numel() + b.numel()), torch.float32)
        say(f"[kernel] block_diff, {tag} call, f32: {store_line(t)}")
        rows.append(dict(
            name="block_diff", call=tag, shape=list(ks.shape),
            launches=launches["block_diff"],
            max_abs_err=errs[("block_diff", ks.dtype)],
            max_abs_err_f32=errs[("block_diff", torch.float32)], **t))
        del a, b
    return rows


def dense_decode_row(tag, dev, kept, launches):
    """``flash_decode`` on the dense loop's largest call (its last step of
    round 2), against its plain version in bf16 and f32, twice for the
    same bits and bit-equal to the paged kernel on the same rows, timed in
    the path's type; its kernel-table row."""
    from repro_torch.kernels import ops, ref

    _, (q, k, v, kv_len, window), kw = kept
    c = kw.get("softcap", 0.0)
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
        got = ops.flash_decode(qq, kk, vv, kv_len, window, softcap=c)
        errs[dt] = check("flash_decode", got, ref.flash_decode_ref(
            qq, kk, vv, kv_len, window, softcap=c), dt)
        assert torch.equal(ops.flash_decode(qq, kk, vv, kv_len, window,
                                            softcap=c),
                           got), (tag, dt, "two calls differ")
    B, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    cols = torch.arange(Sk, device=dev)
    kl = kv_len.long()[:, None]
    mask = (cols[None] < kl) & (kl - 1 - cols[None] < window)
    n = int(mask.sum().item())
    t = decode_times(Timer(dev), lambda: ops.flash_decode(q, k, v, kv_len,
                                                          window, softcap=c),
                     lambda: ref.flash_decode_ref(q, k, v, kv_len, window,
                                                  softcap=c),
                     None if c else sdpa_decode(q, k, v, mask),
                     nbytes(q, kv_len) + nbytes(q)
                     + 2 * n * KV * hd * k.element_size(), 4 * hd * H * n,
                     q.dtype)
    say(f"[kernel] flash_decode, {tag} dense loop's call, q {list(q.shape)} "
        f"over {list(k.shape)}, kv_len {kv_len.tolist()}, window {window}, "
        f"{f'capped at {c}, ' if c else ''}{q.dtype}: {times_line(t)}, "
        f"max abs err "
        f"{errs[torch.bfloat16]:.3g} (bf16) / {errs[torch.float32]:.3g} "
        f"(f32); two calls bit-equal")
    return dict(name="flash_decode", call=f"{tag} dense",
                shape=list(q.shape) + [Sk], launches=launches,
                max_abs_err=errs[q.dtype],
                max_abs_err_f32=errs[torch.float32], **t)


def gemma_edges(dev):
    """[gemma3 hd256]: the attention kernels at head dim 256 under a
    binding window, at Gemma3-12B's heads (16 over 8) and Gemma3-1B's (4
    over 1), in bf16 and f32, each against its plain version and twice
    for the same bits: ``flash_decode`` over Sk 1536 with a window of
    1024 and ragged lengths (1536, 1, 1100, 700), and
    ``flash_decode_paged`` over the same rows as pages of 32, bit-equal
    to it; ``flash_prefill`` at S 1536 with the window and a ragged
    kv_len, and ``flash_prefill_paged`` over the same rows (pages for the
    first 1491, a tail of 45) bit-equal to the dense kernel. CUDA-event
    times at 12B's heads in f32, the type of the recovered KV."""
    from repro_torch.kernels import ops, ref

    t_phase = time.perf_counter()
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(22)
    Sk, W, hd = 1536, 1024, 256
    for H, KV in ((16, 8), (4, 1)):
        for dt in (torch.bfloat16, torch.float32):
            def rnd(*shape):
                return torch.randn(*shape, generator=g, device=dev).to(dt)

            def twice(fn, what):
                got = fn()
                assert torch.equal(fn(), got), (what, H, dt,
                                                "two calls differ")
                return got

            B = 4
            q, k, v = rnd(B, H, hd), rnd(B, Sk, KV, hd), rnd(B, Sk, KV, hd)
            kl = torch.tensor([Sk, 1, 1100, 700], device=dev,
                              dtype=torch.int32)
            nbt = Sk // 32
            pk = k.reshape(B * nbt, 32, KV, hd)
            pv = v.reshape(B * nbt, 32, KV, hd)
            pidx = torch.arange(B * nbt, device=dev, dtype=torch.int32
                                ).reshape(B, nbt)
            dense = twice(lambda: ops.flash_decode(q, k, v, kl, W),
                          "flash_decode")
            e_d = check("flash_decode", dense,
                        ref.flash_decode_ref(q, k, v, kl, W), dt)
            paged = twice(lambda: ops.flash_decode_paged(q, pk, pv, pidx, kl,
                                                         window=W),
                          "flash_decode_paged")
            assert torch.equal(paged, dense), (H, dt, "paged != dense")
            e_p = check("flash_decode_paged", paged,
                        ref.flash_decode_paged_ref(q, pk, pv, pidx, kl,
                                                   window=W), dt)
            Bp, cut = 2, 45
            span = Sk - cut
            nbh = -(-span // 32)
            qp, kp, vp = (rnd(Bp, Sk, H, hd), rnd(Bp, Sk, KV, hd),
                          rnd(Bp, Sk, KV, hd))
            pos = torch.arange(Sk, device=dev, dtype=torch.int32).expand(
                Bp, Sk).contiguous()
            klp = torch.tensor([Sk, Sk - cut], device=dev,
                               dtype=torch.int32)
            fp = twice(lambda: ops.flash_attention(qp, kp, vp, q_pos=pos,
                                                   window=W, kv_len=klp),
                       "flash_prefill")
            e_f = check("flash_prefill", fp, ref.flash_attention_ref(
                qp, kp, vp, q_pos=pos, window=W, kv_len=klp), dt)
            ppk = kp[:, :nbh * 32].reshape(Bp * nbh, 32, KV, hd)
            ppv = vp[:, :nbh * 32].reshape(Bp * nbh, 32, KV, hd)
            ppidx = torch.arange(Bp * nbh, device=dev, dtype=torch.int32
                                 ).reshape(Bp, nbh)
            tk, tv = kp[:, span:].contiguous(), vp[:, span:].contiguous()
            pp = twice(lambda: ops.flash_prefill_paged(
                qp, ppk, ppv, ppidx, tk, tv, span_len=span, window=W),
                "flash_prefill_paged")
            assert torch.equal(pp, ops.flash_attention(
                qp, kp, vp, q_pos=pos, window=W)), (H, dt, "paged != dense")
            e_pp = check("flash_prefill_paged", pp,
                         ref.flash_attention_paged_ref(
                             qp, ppk, ppv, ppidx, tk, tv, span_len=span,
                             window=W), dt)
            say(f"[gemma3 hd256] heads {H}/{KV}, {dt}: flash_decode (Sk "
                f"{Sk}, window {W}, kv_len {kl.tolist()}) max abs err "
                f"{e_d:.3g}, flash_decode_paged {e_p:.3g} and bit-equal to "
                f"it; flash_prefill (S {Sk}, window {W}, kv_len "
                f"{klp.tolist()}) {e_f:.3g}; flash_prefill_paged (span "
                f"{span} + tail {cut}) {e_pp:.3g} and bit-equal to the dense "
                f"kernel; every call twice bit-equal")
            if (H, dt) != (16, torch.float32):
                continue
            mask = torch.arange(Sk, device=dev)[None] < kl[:, None]
            mask &= kl[:, None] - 1 - torch.arange(Sk, device=dev)[None] < W
            n = int(mask.sum().item())
            dbytes = nbytes(q, kl) + nbytes(q) + 2 * n * KV * hd * 4
            for name, fn, plain in (
                    ("flash_decode", lambda: ops.flash_decode(q, k, v, kl, W),
                     lambda: ref.flash_decode_ref(q, k, v, kl, W)),
                    ("flash_decode_paged",
                     lambda: ops.flash_decode_paged(q, pk, pv, pidx, kl,
                                                    window=W),
                     lambda: ref.flash_decode_paged_ref(q, pk, pv, pidx, kl,
                                                        window=W))):
                t = decode_times(timer, fn, plain,
                                 sdpa_decode(q, k, v, mask), dbytes,
                                 4 * hd * H * n, dt)
                say(f"[kernel] {name} at hd 256, q {list(q.shape)} over "
                    f"{Sk} rows, window {W}, f32: {times_line(t)}")
            t = prefill_times(timer, qp, kp, vp, pos, W, klp)
            say(f"[kernel] flash_prefill at hd 256, q {list(qp.shape)} over "
                f"{Sk} rows, window {W}, kv_len {klp.tolist()}, f32: "
                f"{times_line(t)}")
            flops = 4 * hd * H * allowed_cols(pos, W, Sk)
            bms, by = bound(nbytes(qp, ppk, ppv, ppidx, tk, tv) + nbytes(qp),
                            flops, dt, split_tf32=True)
            cols = torch.arange(Sk, device=dev)
            dl = pos.long()[:, :, None] - cols
            pmask = ((dl >= 0) & (dl < W))[:, None]
            qt, kt, vt = (x.transpose(1, 2) for x in (qp, kp, vp))
            t = dict(
                ms=timer(lambda: ops.flash_prefill_paged(
                    qp, ppk, ppv, ppidx, tk, tv, span_len=span, window=W)),
                plain_ms=timer(lambda: ref.flash_attention_paged_ref(
                    qp, ppk, ppv, ppidx, tk, tv, span_len=span, window=W)),
                library_ms=timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=pmask, enable_gqa=True)),
                bound_ms=bms, bound_by=by,
                bound_cuda_core_ms=bound(
                    nbytes(qp, ppk, ppv, ppidx, tk, tv) + nbytes(qp), flops,
                    dt)[0])
            say(f"[kernel] flash_prefill_paged at hd 256, q "
                f"{list(qp.shape)} over {nbh} pages + {cut} tail rows, "
                f"window {W}, f32: {times_line(t)}")
    say(f"[gemma3 hd256] phase {time.perf_counter() - t_phase:.1f} s")


def model_phase(dev, arch, n_layers=None, timed=True, dense=False,
                binds=None, engine_kw=None, embeds=False, heads=None,
                tag=None):
    """[<arch>]: serve (``engine_kw``: engine arguments), hold the path's
    kernels at its head layout, with ``dense`` serve again through the
    dense decode loop on the same weights (bit-equal), with ``embeds``
    run ``frontend_prefill``, then free the weights. ``binds``: the
    rounds in which a sliding window must bind. ``heads`` replaces the
    config's head layout, under ``tag`` (``[serve 112]``). Returns the
    kernel-table rows."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    served = serve_model(dev, arch, n_layers, engine_kw, heads, tag)
    tag = tag or served["cfg"].name
    if binds is not None:
        assert served["binds"] == binds, (tag, served["binds"], binds)
    rows = hold_kernels(tag, dev, served, timed)
    if embeds:
        frontend_prefill(tag, dev, served)
    if dense:
        engine = ServingEngine(served["params"], served["cfg"],
                               paged_decode=False, keep_logits=True,
                               **(engine_kw or {}))
        other, dl, drec = serve_phase(f"{tag} dense", engine,
                                      served["trace"], ops)
        del engine
        bit_equal(f"{tag} dense", served["stats"], other,
                  "the paged decode loop's")
        assert dl["flash_decode"] > 0 and dl["flash_decode_paged"] == 0, dl
        rows.append(dense_decode_row(tag, dev, drec.kept["flash_decode"],
                                     dl["flash_decode"]))
        del drec                  # it keeps clones of the kernels' inputs
    before, weights = served["before"], served["weights"]
    served.clear()
    del served
    freed(tag, before, weights)
    say(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")
    return rows


def frontend_prefill(tag, dev, served, n_embeds=64):
    """A model with a stubbed frontend on its embedding path: ``prefill``
    of tokens [8, 224] whose first ``n_embeds`` positions take seeded
    frontend embeddings [8, n_embeds, D] (counts zeroed before, read
    after: one ``flash_prefill`` launch a layer, no plain version);
    finite logits of the expected shape, other than the tokens-only
    prefill's, and bit-equal to ``forward``'s on the same inputs (one
    layer loop)."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward, prefill

    params, cfg = served["params"], served["cfg"]
    g = torch.Generator(device=dev).manual_seed(23)
    B, S = 8, 224
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    emb = torch.randn(B, n_embeds, cfg.d_model, generator=g,
                      device=dev).to(torch.bfloat16)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, tokens, frontend_embeds=emb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
    assert launches["flash_prefill"] == cfg.n_layers, launches
    assert not any(plain.values()), plain
    assert logits.shape == (B, S, cfg.vocab_size), logits.shape
    assert bool(logits.isfinite().all()), tag
    assert cache["k"].shape[:3] == (cfg.n_layers, B, S), cache["k"].shape
    del cache
    plain_logits, _ = prefill(params, cfg, tokens)
    assert not torch.equal(plain_logits, logits), "the embeddings were lost"
    del plain_logits
    fl, _ = forward(params, cfg, tokens, frontend_embeds=emb)
    assert torch.equal(fl, logits), "forward != prefill with embeds"
    del fl, logits
    say(f"[{tag}] prefill with {cfg.frontend} frontend embeddings "
        f"[{B}, {n_embeds}, {cfg.d_model}] (seed 23) over tokens [{B}, "
        f"{S}]: {launches['flash_prefill']} flash_prefill launches, no "
        f"plain version, finite logits bit-equal to forward's and other "
        f"than the tokens-only prefill's; {ms:.1f} ms (host clock)")


def ssm_phase(dev):
    """[mamba2-2.7b]: the attention-free model at full width and depth
    (64 layers, bf16, seed 0) through ``ServingEngine(params, cfg)``:
    TokenDance falls back to the recompute policy and the dense decode
    loop; counts zeroed before and read after — no kernel launched (no
    attention, no KV to align, compress or restore) and no plain version
    run; finite first-token logits; the peak memory (the SSD chunk
    tensors at 80 heads of 64, state 128). Then the prefix policy on the
    same weights and trace: constructed (as in JAX), every round
    recomputed, bit-equal to the fallback; the weights freed."""
    from repro_torch.configs import get_config
    from repro_torch.core.rounds import generate_trace
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    cfg = get_config("mamba2-2.7b")
    tag = cfg.name
    say(f"[{tag}] {cfg.n_layers} of {cfg.n_layers} layers (no depth cut), "
        f"d {cfg.d_model}, no attention, SSM d_inner {cfg.d_inner}, "
        f"{cfg.ssm_heads} heads of {cfg.ssm_headdim}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, "
        f"tied embeddings {cfg.tie_embeddings}, {cfg.dtype}, "
        f"~{cfg.param_count() / 1e9:.2f} B params")
    before = torch.cuda.memory_allocated()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    trace = generate_trace("agent_society", 8, 3, cfg.vocab_size, seed=0,
                           jitter_hist=False)
    engine = ServingEngine(params, cfg, keep_logits=True)
    assert engine.policy.name == "recompute", engine.policy.name
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    stats = engine.serve(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    for st in stats:
        say(f"[{tag}] round {st.round_idx}: prompt {st.prompt_len}, round "
            f"{st.t_round * 1e3:.1f} ms (recover {st.t_recover * 1e3:.1f}, "
            f"decode {st.t_decode * 1e3:.1f}, store "
            f"{st.t_store * 1e3:.1f}), policy {st.mode}, persistent "
            f"{st.persistent_bytes} B")
        assert st.outputs.shape == (8, engine.gen_len), st.outputs.shape
        assert ((st.outputs >= 0) & (st.outputs < cfg.vocab_size)).all()
        assert np.isfinite(st.first_logits).all(), st.round_idx
        assert st.first_logits.shape == (8, cfg.vocab_size)
        assert st.persistent_bytes == 0, st.persistent_bytes
    say(f"[{tag}] serve {wall:.2f} s; launches {launches}  plain-version "
        f"calls {plain}; peak device memory {gib(peak):.2f} GiB (weights "
        f"{gib(weights):.2f})")
    assert not any(launches.values()), f"kernels launched: {launches}"
    assert not any(plain.values()), f"plain versions ran: {plain}"
    # the prefix policy: constructed, as in JAX; no attention KV to cache,
    # so every round recomputes, bit-equal to the recompute fallback
    pengine = ServingEngine(params, cfg, "prefix", keep_logits=True)
    ops.reset_launches()
    pstats = pengine.serve(generate_trace("agent_society", 8, 3,
                                          cfg.vocab_size, seed=0,
                                          jitter_hist=False))
    torch.cuda.synchronize()
    assert pengine.policy.name == "prefix", pengine.policy.name
    assert not any(ops.LAUNCHES.values()) and \
        not any(ops.PLAIN_CALLS.values()), dict(ops.LAUNCHES)
    for a, b in zip(pstats, stats):
        assert np.array_equal(a.outputs, b.outputs), a.round_idx
        assert np.array_equal(a.first_logits, b.first_logits), a.round_idx
        assert a.persistent_bytes == 0 and not a.reuse.get("prefix_len")
    say(f"[{tag}] prefix policy: constructed, every round recomputed "
        f"(nothing cached, no prefix reused), outputs and first-token "
        f"logits bit-equal to the recompute fallback's")
    del engine, pengine, stats, pstats, params
    freed(tag, before + weights, weights)
    say(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")


def softcap_edges(dev):
    """[softcap edges]: the capped instances at shapes Grok's path does
    not give them, q scaled by 300 so that |s| is far past the cap of 30
    (the tanh saturates), in bf16 and f32, each against its plain version
    and twice for the same bits: ``flash_prefill_paged`` at the main
    path's round-2 pool shape (q [8,256,28,128] over 7 pages of 32 and a
    32-row tail a sequence, from a pool of 72 pages), bit-equal to the
    dense kernel on the gathered rows; head dim 256 (Gemma3-12B's heads,
    16 over 8) in ``flash_attention`` (S 512, causal) and in both decode
    kernels (Sk 1024, ragged lengths, bit-equal to each other). The
    capped paged kernel is timed in f32 and said on a ``[kernel]`` line;
    no path launches these calls, so the kernel table gets no row."""
    from repro_torch.kernels import ops, ref

    t_phase = time.perf_counter()
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(12)
    c, mult = 30.0, 300.0

    def twice(fn, what):
        got = fn()
        assert torch.equal(fn(), got), (what, "two calls differ")
        return got

    for dt in (torch.bfloat16, torch.float32):
        def rnd(*shape, m=1.0):
            return (m * torch.randn(*shape, generator=g, device=dev)).to(dt)

        B, H, KV, hd, bt, nbh, T, P = 8, 28, 4, 128, 32, 7, 32, 72
        span = nbh * bt
        q = rnd(B, span + T, H, hd, m=mult)
        pk, pv = rnd(P, bt, KV, hd), rnd(P, bt, KV, hd)
        pidx = torch.randperm(P, generator=g, device=dev)[: B * nbh].reshape(
            B, nbh).to(torch.int32).contiguous()
        tk, tv = rnd(B, T, KV, hd), rnd(B, T, KV, hd)
        args = (q, pk, pv, pidx, tk, tv)
        got = twice(lambda: ops.flash_prefill_paged(*args, span_len=span,
                                                    softcap=c),
                    "flash_prefill_paged capped")
        e_p = check("flash_prefill_paged", got, ref.flash_attention_paged_ref(
            *args, span_len=span, softcap=c), dt)
        kd, vd = ref.paged_kv_ref(pk, pv, pidx, tk, tv, span)
        kd, vd = kd.contiguous(), vd.contiguous()
        pos = torch.arange(span + T, device=dev, dtype=torch.int32).expand(
            B, span + T).contiguous()
        assert torch.equal(got, ops.flash_attention(
            q, kd, vd, q_pos=pos, window=2 ** 31 - 1, softcap=c)), \
            "capped paged prefill != dense"
        if dt == torch.float32:
            flops = 4 * hd * H * allowed_cols(pos, 2 ** 31 - 1, span + T)
            n_b = nbytes(*args) + nbytes(q)
            bms, by = bound(n_b, flops, dt, split_tf32=True)
            t = dict(ms=timer(lambda: ops.flash_prefill_paged(
                *args, span_len=span, softcap=c)),
                plain_ms=timer(lambda: ref.flash_attention_paged_ref(
                    *args, span_len=span, softcap=c)),
                library_ms=None, bound_ms=bms, bound_by=by,
                bound_cuda_core_ms=bound(n_b, flops, dt)[0])
            say(f"[kernel] flash_prefill_paged capped at {c}, q "
                f"{list(q.shape)} (x {mult}) over {nbh} pages + {T} tail "
                f"rows, f32 (softcap edge, on no path): {times_line(t)}, "
                f"max abs err {e_p:.3g}")
        del kd, vd

        H, KV, hd, S = 16, 8, 256, 512
        q, k, v = rnd(2, S, H, hd, m=mult), rnd(2, S, KV, hd), rnd(2, S, KV,
                                                                   hd)
        pos = torch.arange(S, device=dev, dtype=torch.int32).expand(
            2, S).contiguous()
        got = twice(lambda: ops.flash_attention(q, k, v, q_pos=pos, window=S,
                                                softcap=c),
                    "flash_prefill hd 256 capped")
        e_f = check("flash_prefill", got, ref.flash_attention_ref(
            q, k, v, q_pos=pos, window=S, softcap=c), dt)
        Sk = 1024
        qd, kk, vv = rnd(4, H, hd, m=mult), rnd(4, Sk, KV, hd), rnd(4, Sk, KV,
                                                                   hd)
        kl = torch.tensor([Sk, 1, 700, 333], device=dev, dtype=torch.int32)
        dpk = kk.reshape(4 * Sk // 32, 32, KV, hd)
        dpv = vv.reshape(4 * Sk // 32, 32, KV, hd)
        didx = torch.arange(4 * Sk // 32, device=dev, dtype=torch.int32
                            ).reshape(4, Sk // 32)
        dense = twice(lambda: ops.flash_decode(qd, kk, vv, kl, Sk, softcap=c),
                      "flash_decode hd 256 capped")
        e_d = check("flash_decode", dense, ref.flash_decode_ref(
            qd, kk, vv, kl, Sk, softcap=c), dt)
        paged = twice(lambda: ops.flash_decode_paged(qd, dpk, dpv, didx, kl,
                                                     softcap=c),
                      "flash_decode_paged hd 256 capped")
        assert torch.equal(paged, dense), "capped paged decode != dense"
        say(f"[softcap edges] {dt}, cap {c}, q x {mult}: flash_prefill_paged "
            f"[8,256,28,128] over the pool max abs err {e_p:.3g} and "
            f"bit-equal to the dense kernel; hd 256: flash_attention [2,"
            f"{S},{H},{hd}] {e_f:.3g}, flash_decode (Sk {Sk}, kv_len "
            f"{kl.tolist()}) {e_d:.3g}, flash_decode_paged bit-equal to "
            f"it; every call twice bit-equal")
    say(f"[softcap edges] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------- phase 5
def hybrid(dev):
    """Hymba-1.5B at full width through the engine's normal entry point;
    returns the launch counts and the kernels' inputs kept."""
    from repro_torch.configs import get_config
    from repro_torch.core.rounds import generate_trace
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_config("hymba-1.5b")
    say(f"[hybrid] {cfg.name}: {cfg.n_layers} of {cfg.n_layers} layers (no "
        f"depth cut), d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}"
        f", head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, SSM state {cfg.ssm_state} x {cfg.ssm_heads} "
        f"heads of {cfg.ssm_headdim}, window {cfg.sliding_window}, "
        f"{cfg.dtype}, ~{cfg.param_count() / 1e9:.2f} B params")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    say(f"[hybrid] init_params(seed 0) {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    trace = generate_trace("agent_society", 8, 3, cfg.vocab_size, seed=0,
                           jitter_hist=False)
    engine = ServingEngine(params, cfg, "tokendance", keep_logits=True)
    assert engine.policy.name == "recompute", engine.policy.name
    torch.cuda.reset_peak_memory_stats()
    with Recorder(ops) as rec:
        ops.reset_launches()
        t0 = time.perf_counter()
        stats = engine.serve(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        plain = dict(ops.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for st in stats:
        say(f"[hybrid] round {st.round_idx}: prompt {st.prompt_len}, "
            f"round {st.t_round * 1e3:.1f} ms (recover "
            f"{st.t_recover * 1e3:.1f}, decode {st.t_decode * 1e3:.1f}, "
            f"store {st.t_store * 1e3:.1f}), policy {st.mode}")
        assert st.outputs.shape == (8, engine.gen_len), st.outputs.shape
        assert ((st.outputs >= 0) & (st.outputs < cfg.vocab_size)).all()
        assert np.isfinite(st.first_logits).all(), st.round_idx
        assert st.first_logits.shape == (8, cfg.vocab_size)
    say(f"[hybrid] serve {wall:.2f} s for {len(stats)} rounds, peak device "
        f"memory {peak:.2f} GiB")
    say(f"[hybrid] launches {launches}  plain-version calls {plain}")
    steps = len(stats) * (engine.gen_len - 1)
    assert launches["flash_decode"] == steps * cfg.n_layers, launches
    assert launches["flash_prefill"] > 0, launches
    assert launches["flash_decode_paged"] == 0, launches
    assert not any(plain.values()), f"plain versions ran: {plain}"
    del engine, params
    torch.cuda.empty_cache()
    return launches, rec.kept


def hybrid_prefill(dev, kept):
    """The flash_prefill kernel against its plain version at the hybrid
    path's shapes (25 query heads over 5 KV heads, G = 5; head dim 64):
    its largest recompute prefill call, and a prefill of 1536 tokens at
    those heads whose window of 1024 binds, with a ragged kv_len."""
    from repro_torch.kernels import ops, ref

    timer = Timer(dev)
    _, (q, k, v), kw = kept["flash_attention"]
    q_pos, window, kv_len = kw["q_pos"], kw["window"], kw.get("kv_len")
    assert q.dtype == torch.bfloat16, q.dtype
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
        errs[dt] = check(
            "flash_prefill",
            ops.flash_attention(qq, kk, vv, q_pos=q_pos, window=window,
                                kv_len=kv_len),
            ref.flash_attention_ref(qq, kk, vv, q_pos=q_pos, window=window,
                                    kv_len=kv_len), dt)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = torch.Generator(device=dev).manual_seed(1)
    Se = 1536
    qe, ke, ve = (torch.randn(2, Se, n, hd, generator=g, device=dev)
                  for n in (H, KV, KV))
    pe = torch.arange(Se, device=dev, dtype=torch.int32).expand(2, Se)
    pe = pe.contiguous()
    kl = torch.tensor([Se, Se - 45], device=dev, dtype=torch.int32)
    for dt in (torch.bfloat16, torch.float32):
        qq, kk, vv = qe.to(dt), ke.to(dt), ve.to(dt)
        errs[(dt, "window")] = check(
            "flash_prefill",
            ops.flash_attention(qq, kk, vv, q_pos=pe, window=1024,
                                kv_len=kl),
            ref.flash_attention_ref(qq, kk, vv, q_pos=pe, window=1024,
                                    kv_len=kl), dt)
    for dt in (q.dtype, torch.float32):
        t = prefill_times(timer, q.to(dt), k.to(dt), v.to(dt), q_pos, window,
                          kv_len)
        say(f"[kernel] flash_prefill on the hybrid path: q {list(q.shape)} "
            f"over {list(k.shape)} (G {H // KV}, window {window}) {dt}: "
            f"{times_line(t)}, max abs err {errs[dt]:.3g}")
    say(f"[kernel] flash_prefill at S {Se} with a binding window 1024 and "
        f"kv_len {kl.tolist()} (hybrid heads): max abs err "
        f"{errs[(torch.bfloat16, 'window')]:.3g} (bf16) / "
        f"{errs[(torch.float32, 'window')]:.3g} (f32)")


def decode_kernel(dev, launches, kept, dense_kept):
    """The flash_decode kernel against its plain version and the paged
    kernel on the inputs kept from the hybrid path (``kept``) and the
    dense Qwen path (``dense_kept``), each in bf16 and f32, twice for the
    same bits, and its times in both types; returns its kernel-table
    row (the hybrid path's call in its own type)."""
    from repro_torch.kernels import ops, ref

    timer = Timer(dev)

    def allowed(kv_len, window, Sk):
        cols = torch.arange(Sk, device=dev)
        kl = kv_len.long()[:, None]
        return (cols[None] < kl) & (kl - 1 - cols[None] < window)

    def as_pages(k, v):
        """The same KV as 32-row pages in order, and their page table."""
        B, Sk, KV, hd = k.shape
        nbt = Sk // 32
        assert nbt * 32 == Sk, Sk
        pidx = torch.arange(B * nbt, device=dev, dtype=torch.int32).reshape(
            B, nbt)
        return (k.reshape(B * nbt, 32, KV, hd), v.reshape(B * nbt, 32, KV, hd),
                pidx)

    def measure(q, k, v, kv_len, window):
        """The bytes are q, kv_len and the output plus the allowed rows of
        K and V, read once per KV head."""
        H, hd = q.shape[1:]
        KV = k.shape[2]
        mask = allowed(kv_len, window, k.shape[1])
        rows = int(mask.sum().item())
        return decode_times(
            timer, lambda: ops.flash_decode(q, k, v, kv_len, window),
            lambda: ref.flash_decode_ref(q, k, v, kv_len, window),
            sdpa_decode(q, k, v, mask),
            nbytes(q, kv_len) + nbytes(q)
            + 2 * rows * KV * hd * k.element_size(), 4 * hd * H * rows,
            q.dtype)

    errs, times = {}, {}
    cases = {"hybrid": kept["flash_decode"], "dense": dense_kept}
    for key, (_, (q, k, v, kv_len, window), _) in cases.items():
        for dt in (torch.bfloat16, torch.float32):
            qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
            got = ops.flash_decode(qq, kk, vv, kv_len, window)
            errs[(key, dt)] = check(
                "flash_decode", got,
                ref.flash_decode_ref(qq, kk, vv, kv_len, window), dt)
            assert torch.equal(ops.flash_decode(qq, kk, vv, kv_len, window),
                               got), (key, dt, "two calls differ")
            # identical KV as 32-row pages: the paged kernel's bits
            assert torch.equal(
                ops.flash_decode(qq, kk, vv, kv_len, kk.shape[1]),
                ops.flash_decode_paged(qq, *as_pages(kk, vv), kv_len)), \
                (key, dt, "paged != dense")
            times[(key, dt)] = measure(qq, kk, vv, kv_len, window)
            say(f"[kernel] flash_decode on the {key} path: q "
                f"{list(q.shape)} over {list(k.shape)}, kv_len "
                f"{kv_len.tolist()}, window {window}, {dt}: "
                f"{times_line(times[(key, dt)])}, max abs err "
                f"{errs[(key, dt)]:.3g}; two calls bit-equal, paged == "
                f"dense bit-equal")
    # edges: Sk 1536 with a window of 1024 that binds, ragged lengths, at
    # the two paths' head shapes
    g = torch.Generator(device=dev).manual_seed(0)
    for key, (_, (q, k, _, _, _), _) in cases.items():
        B, H, hd = q.shape
        KV = k.shape[2]
        qe = torch.randn(B, H, hd, generator=g, device=dev).to(q.dtype)
        ke = torch.randn(B, 1536, KV, hd, generator=g, device=dev).to(q.dtype)
        ve = torch.randn(B, 1536, KV, hd, generator=g, device=dev).to(q.dtype)
        kl = torch.randint(1, 1537, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        kl[0], kl[-1] = 1536, 1
        errs[(key, "window")] = check(
            "flash_decode", ops.flash_decode(qe, ke, ve, kl, 1024),
            ref.flash_decode_ref(qe, ke, ve, kl, 1024), q.dtype)
    say(f"[kernel] flash_decode with a binding window 1024 at Sk 1536: max "
        f"abs err {errs[('dense', 'window')]:.3g} (Qwen heads, "
        f"{dense_kept[1][0].dtype}) / {errs[('hybrid', 'window')]:.3g} "
        f"(Hymba heads, {kept['flash_decode'][1][0].dtype})")
    # more than 32 splits a pair, so the merge runs past its first chunk:
    # kv_len 2049 (a last chunk of one split) and 4096 (two full chunks)
    for key, (_, (q, k, _, _, _), _) in cases.items():
        B, H, hd = q.shape
        KV = k.shape[2]
        ql = torch.randn(B, H, hd, generator=g, device=dev).to(q.dtype)
        kl_, vl = (torch.randn(B, 4096, KV, hd, generator=g,
                               device=dev).to(q.dtype) for _ in range(2))
        lens = torch.tensor([(2049, 4096, 3001, 1)[i % 4] for i in range(B)],
                            device=dev, dtype=torch.int32)
        got = ops.flash_decode(ql, kl_, vl, lens, 4096)
        errs[(key, "long")] = check("flash_decode", got, ref.flash_decode_ref(
            ql, kl_, vl, lens, 4096), q.dtype)
        assert torch.equal(ops.flash_decode(ql, kl_, vl, lens, 4096), got), \
            (key, "long", "two calls differ")
        assert torch.equal(ops.flash_decode_paged(ql, *as_pages(kl_, vl),
                                                  lens), got), \
            (key, "long", "paged != dense")
    say(f"[kernel] flash_decode at Sk 4096, kv_len 2049/4096/3001/1 (up to "
        f"64 splits a pair): max abs err {errs[('dense', 'long')]:.3g} "
        f"(Qwen heads) / {errs[('hybrid', 'long')]:.3g} (Hymba heads); two "
        f"calls bit-equal, paged == dense bit-equal")

    # the two kernels on the same rows (no window), in turns: dense, paged,
    # paged, dense
    for key, (_, (q, k, v, kv_len, _), _) in cases.items():
        pages = as_pages(k, v)

        def dense_fn(q=q, k=k, v=v, kv_len=kv_len):
            return ops.flash_decode(q, k, v, kv_len, k.shape[1])

        def paged_fn(q=q, pages=pages, kv_len=kv_len):
            return ops.flash_decode_paged(q, *pages, kv_len)

        t = [timer(f) for f in (dense_fn, paged_fn, paged_fn, dense_fn)]
        say(f"[kernel] flash_decode vs flash_decode_paged on the {key} "
            f"path's rows ({q.dtype}): dense {t[0]:.4f} / {t[3]:.4f} ms, "
            f"paged {t[1]:.4f} / {t[2]:.4f} ms")

    _, (q, k, *_), _ = kept["flash_decode"]
    return dict(
        name="flash_decode", shape=list(q.shape) + [k.shape[1]],
        max_abs_err=errs[("hybrid", q.dtype)],
        max_abs_err_f32=errs[("hybrid", torch.float32)],
        launches=launches["flash_decode"], **times[("hybrid", q.dtype)])


# ------------------------------------------------------------ training
def bwd_times(timer, q, k, v, out, dout, q_pos, window, kv_len=None,
              softcap=0.0):
    """CUDA-event times of ``ops.flash_attention_bwd``, its plain version
    and, for a plain causal call, SDPA's backward (SDPA's forward plus
    backward minus its forward, GQA, ``is_causal``); and its bound: q, k,
    v, out and dout read once, dq, dk and dv written once, and 2.5 times
    the forward's products over the allowed pairs (dS and dP, dQ, dK, dV:
    five products where the forward has two) at the input type's peak;
    and the rate those products make in the kernel's time
    (``achieved_tflops``)."""
    from repro_torch.kernels import ops, ref

    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    kw = dict(q_pos=q_pos, window=window, kv_len=kv_len, softcap=softcap)
    n_bytes = nbytes(q, k, v, out, dout, q_pos, kv_len) + nbytes(q, k, v)
    flops = 2.5 * 4 * hd * H * allowed_cols(q_pos, window, Sk, kv_len)
    bms, by = bound(n_bytes, flops, q.dtype, split_tf32=True)
    library = None
    causal = (Sq == Sk and kv_len is None and window >= Sk and not softcap
              and torch.equal(q_pos, torch.arange(
                  Sq, device=q.device, dtype=torch.int32).expand(B, Sq)))
    if causal:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = dout.transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

        def sdpa_both():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
            return torch.autograd.grad(o, (qt, kt, vt), dot)

        library = timer(sdpa_both, reps=7) - timer(sdpa_fwd, reps=7)
    ms = timer(lambda: ops.flash_attention_bwd(q, k, v, out, dout, **kw),
               reps=7)
    return dict(
        ms=ms, plain_ms=timer(lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, dout, **kw), reps=5),
        library_ms=library, bound_ms=bms, bound_by=by,
        bound_cuda_core_ms=bound(n_bytes, flops, q.dtype)[0],
        achieved_tflops=flops / ms / 1e9)


def bwd_case(dev, g, dtype, B, Sq, Sk, H, KV, hd, window=None, kv_len=None,
             softcap=0.0, qs=1.0):
    """Inputs of one backward call, its result and its plain version's,
    with the two calls' bit equality checked: (errs, got, inputs)."""
    from repro_torch.kernels import ops, ref

    q = (qs * torch.randn(B, Sq, H, hd, generator=g, device=dev)).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dtype)
    dout = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dtype)
    q_pos = (torch.arange(Sq, device=dev, dtype=torch.int32) + (Sk - Sq)) \
        .expand(B, Sq).contiguous()
    kl = (None if kv_len is None else
          torch.tensor(kv_len, device=dev, dtype=torch.int32))
    kw = dict(q_pos=q_pos, window=window or Sk, kv_len=kl, softcap=softcap)
    out = ops.flash_attention(q, k, v, **kw)
    got = ops.flash_attention_bwd(q, k, v, out, dout, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        ("flash_prefill_bwd: two calls differ", q.shape, k.shape, kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    errs = [check("flash_prefill_bwd", a, b, dtype)
            for a, b in zip(got, want)]
    return errs, (q, k, v, out, dout, kw)


def train_kernel(dev, launches):
    """[train] the backward kernel (``flash_prefill_bwd``) against its
    plain version at Qwen3-4B's layer shape in training, q [1, 4096, 32,
    128] and k/v [1, 4096, 8, 128], causal, in bf16 and f32: max abs
    errors of dq, dk and dv, two calls bit-equal, CUDA-event times beside
    its bound and SDPA's backward; then at the edges (head dims 64 and
    256 with a binding window and a ragged kv_len, soft cap 30, G 1 and
    G 8). Returns its kernel-table row (``launches``: a training step's)."""
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(24)
    errs, times = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        e, args = bwd_case(dev, g, dt, 1, 4096, 4096, 32, 8, 128)
        errs[dt] = max(e)
        q, k, v, out, dout, kw = args
        times[dt] = bwd_times(timer, q, k, v, out, dout, **kw)
        say(f"[train] flash_prefill_bwd q {list(q.shape)} k/v "
            f"{list(k.shape)} causal ({dt}): max abs err dq {e[0]:.3g} dk "
            f"{e[1]:.3g} dv {e[2]:.3g}, two calls bit-equal; "
            f"{times_line(times[dt])}; "
            f"{times[dt]['achieved_tflops']:.1f} TFLOP/s of the bound's "
            f"products")
        del q, k, v, out, dout, args
    edges = [  # (B, Sq, Sk, H, KV, hd, window, kv_len, softcap, q scale)
        (2, 1000, 1000, 8, 8, 64, 300, [1000, 777], 0.0, 1.0),     # G 1
        (2, 600, 600, 16, 2, 256, 200, [600, 450], 0.0, 1.0),      # G 8
        (1, 700, 700, 32, 8, 128, None, None, 30.0, 8.0),          # capped
        (2, 333, 333, 16, 2, 64, 100, [333, 301], 30.0, 8.0),
        (1, 257, 257, 8, 1, 256, None, None, 30.0, 8.0)]
    for dt in (torch.bfloat16, torch.float32):
        for B, Sq, Sk, H, KV, hd, w, kl, c, qs in edges:
            e, _ = bwd_case(dev, g, dt, B, Sq, Sk, H, KV, hd, w, kl, c, qs)
            say(f"[train] flash_prefill_bwd edge B {B} S {Sq} H {H} KV {KV} "
                f"hd {hd} window {w} kv_len {kl} softcap {c} ({dt}): max "
                f"abs err dq {e[0]:.3g} dk {e[1]:.3g} dv {e[2]:.3g}, two "
                f"calls bit-equal")
    return dict(name="flash_prefill_bwd", shape=[1, 4096, 32, 128, 8],
                max_abs_err=errs[torch.bfloat16],
                max_abs_err_f32=errs[torch.float32], launches=launches,
                call="Qwen3-4B training layer, bf16",
                **times[torch.bfloat16])


def train_phase(dev, heads=None, tag="train", n_train=3):
    """[train]: Qwen3-4B trained at full width and depth (36 layers, d
    2560, 32 query heads over 8, head dim 128, vocab 151936; bf16 weights
    random from seed 0) on ``SyntheticTokens`` batches of 1 x 4096 (the
    ``train_4k`` length), ``remat=True``: one step with the launch counts
    zeroed before and read after (72 ``flash_prefill``, 36
    ``flash_prefill_bwd``, no plain version), one step with CUDA events
    between forward, backward and optimizer, then ``n_train`` steps
    through ``train`` timed on the host clock (tokens/s); every loss
    finite; the peak memory. Then the model is freed. ``heads`` replaces
    the config's head layout (``[train heads]``). Returns the launches of
    a step."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, DataConfig,
                                      SyntheticTokens, init_adamw,
                                      make_train_step, train)

    t_phase = time.perf_counter()
    cfg = get_config("qwen3-4b").replace(**(heads or {}))
    S, B = INPUT_SHAPES["train_4k"].seq_len, 1
    say(f"[{tag}] {cfg.name}: {cfg.n_layers} of {cfg.n_layers} layers (no "
        f"depth cut), d {cfg.d_model}, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads}, head dim {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"~{cfg.param_count() / 1e9:.2f} B params; batch {B} x {S}, "
        f"remat, AdamW with f32 moments")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                      global_batch=B, seed=0))
    # JAX's defaults: the learning rate warms up over 100 steps, 3e-6 a
    # step (AdamW's first updates are about lr in every weight's sign)
    opt = AdamWConfig()

    def batch(i):
        toks, mask = data.batch(i)
        return (torch.as_tensor(toks, device=dev),
                torch.as_tensor(mask, device=dev))

    events = {}

    def mark(what):
        events[what] = torch.cuda.Event(enable_timing=True)
        events[what].record()

    state = init_adamw(params)
    step = make_train_step(cfg, opt, mark=mark)
    ops.reset_launches()
    params, state, m = step(params, state, *batch(0))
    torch.cuda.synchronize()
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
    say(f"[{tag}] step 0 (untimed): loss {float(m['loss']):.4f}, grad norm "
        f"{float(m['grad_norm']):.4f}; launches {launches}  plain-version "
        f"calls {plain}")
    assert launches["flash_prefill"] == 2 * cfg.n_layers, launches
    assert launches["flash_prefill_bwd"] == cfg.n_layers, launches
    assert sum(launches.values()) == 3 * cfg.n_layers, launches
    assert not any(plain.values()), f"plain versions ran: {plain}"
    assert np.isfinite(float(m["loss"])), m
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    params, state, m = step(params, state, *batch(1))
    torch.cuda.synchronize()
    t_fwd = start.elapsed_time(events["forward"])
    t_bwd = events["forward"].elapsed_time(events["backward"])
    t_opt = events["backward"].elapsed_time(events["optimizer"])
    step_ms = t_fwd + t_bwd + t_opt
    say(f"[{tag}] step 1: loss {float(m['loss']):.4f}; forward {t_fwd:.1f} "
        f"ms, backward {t_bwd:.1f} ms (the {cfg.n_layers} layers' forward "
        f"again, under remat, included), optimizer {t_opt:.1f} ms, step "
        f"{step_ms:.1f} ms (CUDA events)")
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.launch.roofline import model_flops_for
    mf = model_flops_for(cfg, InputShape("train_4k", S, B, "train"))
    say(f"[{tag}] model FLOPs of the step (roofline.model_flops_for, 6 x "
        f"{cfg.active_param_count() / 1e9:.3f} B active params x {B * S} "
        f"tokens) {mf:.4e}: {mf / (step_ms / 1e3) / 1e12:.1f} TFLOP/s in "
        f"the {step_ms:.1f} ms step, "
        f"{mf / (step_ms / 1e3 * PEAK_FLOPS_BF16):.4f} of the "
        f"{PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16 peak (mfu; the remat "
        f"forward and attention are not model FLOPs)")
    assert np.isfinite(float(m["loss"])), m
    del state, m
    n = n_train
    if n:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train(cfg, opt, (data.batch(i) for i in range(2, 2 + n)), n,
                    params=params, log_every=1, device=dev,
                    log=lambda line: say(f"[{tag}] {line}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        say(f"[{tag}] {n} steps through train(): {wall:.2f} s, "
            f"{n * B * S / wall:.0f} tokens/s (host clock, AdamW state "
            f"set-up and the loss read-back each step included); losses "
            f"{[round(x, 4) for x in res.losses]}")
        assert res.steps == n and all(np.isfinite(res.losses)), res.losses
        del res
    peak = torch.cuda.max_memory_allocated()
    say(f"[{tag}] peak device memory {gib(peak):.2f} GiB (weights "
        f"{gib(weights):.2f}) of the card's "
        f"{gib(torch.cuda.get_device_properties(0).total_memory):.2f}")
    assert peak < torch.cuda.get_device_properties(0).total_memory
    del params
    freed(tag, before + weights, weights)
    say(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def train_parity(dev, heads=None, tag="train parity"):
    """[train parity]: one step's gradients of Qwen3-4B at full width cut
    to 2 layers (bf16, seed 0, a 1 x 4096 batch) with the kernels, against
    the same step with attention routed to the plain forward and backward
    by a spy on ``ops`` (``_flash_forward`` and ``flash_attention_bwd``
    replaced for the call), leaf by leaf with the bf16 tolerance; the q, k
    and v projections' gradients nonzero. ``heads`` replaces the config's
    head layout (``[train heads parity]``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import init_params
    from repro_torch.training import DataConfig, SyntheticTokens
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import value_and_grad

    cfg = get_config("qwen3-4b").replace(n_layers=2, **(heads or {}))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    toks, mask = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=4096, global_batch=1,
        seed=1)).batch(0)
    toks = torch.as_tensor(toks, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    ops.reset_launches()
    loss, _, grads = value_and_grad(params, cfg, toks, mask)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_prefill_bwd"] == 2, dict(ops.LAUNCHES)
    fwd, bwd = ops._flash_forward, ops.flash_attention_bwd

    def plain_fwd(q, k, v, q_pos, kv_len, window, softcap):
        return ref.flash_attention_ref(q, k, v, q_pos=q_pos, window=window,
                                       kv_len=kv_len, softcap=softcap)

    ops._flash_forward = plain_fwd
    ops.flash_attention_bwd = ref.flash_attention_bwd_ref
    try:
        ops.reset_launches()
        ploss, _, pgrads = value_and_grad(params, cfg, toks, mask)
        torch.cuda.synchronize()
        assert not any(ops.LAUNCHES.values()), dict(ops.LAUNCHES)
    finally:
        ops._flash_forward, ops.flash_attention_bwd = fwd, bwd
    def held(path, a, b):
        """(max abs err within the bf16 tolerance, that error over the
        leaf's largest |g|)."""
        err = check("grad " + ".".join(path), a, b, torch.bfloat16)
        return err, err / max(b.float().abs().max().item(), 1e-30)

    errs = [held(path, a, b) for (path, a), (_, b) in
            zip(tree_leaves(grads), tree_leaves(pgrads))]
    worst, worst_rel = max(e for e, _ in errs), max(r for _, r in errs)
    for w in ("wq", "wk", "wv", "q_norm", "k_norm"):
        assert grads["blocks"]["attn"][w].float().abs().max() > 0, w
    say(f"[{tag}] {cfg.name} at full width, 2 layers, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, head dim {cfg.resolved_head_dim}, "
        f"bf16, 1 x 4096: "
        f"loss {float(loss):.6f} with the kernels, {float(ploss):.6f} with "
        f"the plain attention; {len(tree_leaves(grads))} gradient leaves "
        f"within the bf16 tolerance, max abs err {worst:.3g}, max err over "
        f"each leaf's largest |g| {worst_rel:.3g}; wq, wk, wv, q_norm and "
        f"k_norm gradients nonzero")
    del params, grads, pgrads
    freed(tag, before + weights, weights)


def launch_phase(dev):
    """[launch]: (a) the sharded forward and (c) the dry-run subprocess
    (module doc, phase 13b); (b) is printed by [train]."""
    import torch.distributed as dist

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import distribute_params, rules_for
    from repro_torch.models import forward, init_params

    t_phase = time.perf_counter()
    cfg = get_config("qwen3-4b").replace(dtype="float32")
    B, S = 2, 512
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = init_params(cfg, 0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    ref, _ = forward(params, cfg, tokens)
    try:
        mesh = make_debug_mesh()
        rules = rules_for(cfg, INPUT_SHAPES["train_4k"], mesh)
        sharded = distribute_params(params, rules)
        ops.reset_launches()
        out, _ = forward(sharded, cfg, tokens, shard=rules.shard)
        torch.cuda.synchronize()
        launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        say(f"[launch] {cfg.name} at full width and depth ({cfg.n_layers} "
            f"layers, d {cfg.d_model}, {cfg.n_heads} query heads over "
            f"{cfg.n_kv_heads}, vocab {cfg.vocab_size}), f32, tokens [{B}, "
            f"{S}] from seed 1, parameters as DTensors on {mesh} "
            f"({dist.get_backend()}), shard=rules.shard: logits "
            f"{tuple(out.placements)}; launches {launches}  plain-version "
            f"calls {plain}")
        assert launches["flash_prefill"] == cfg.n_layers, launches
        assert sum(launches.values()) == cfg.n_layers, launches
        assert not any(plain.values()), f"plain versions ran: {plain}"
        full = out.full_tensor()
        assert full.shape == (B, S, cfg.vocab_size), full.shape
        assert bool(full.isfinite().all())
        err = (full - ref).abs().max().item()
        say(f"[launch] sharded logits against the unsharded forward's: "
            f"max abs err {err:.3g} (atol 1e-5), bit-equal "
            f"{torch.equal(full, ref)}")
        assert err <= 1e-5, err
        del out, full
        timer = Timer(dev)
        ms_plain = timer(lambda: forward(params, cfg, tokens), reps=5,
                         warm=1)
        ms_sharded = timer(lambda: forward(sharded, cfg, tokens,
                                           shard=rules.shard), reps=5, warm=1)
        say(f"[launch] forward {ms_plain:.2f} ms unsharded, {ms_sharded:.2f} "
            f"ms sharded over the (1, 1) mesh (CUDA events, median of 5)")
        del sharded, timer
    finally:
        dist.destroy_process_group()
    del params, ref
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say(f"[launch] after del: {gib(torch.cuda.memory_allocated()):.2f} GiB "
        f"allocated (was {gib(before):.2f} before the phase)")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               "qwen2-72b", "--shape", "train_4k", "--mesh", "single",
               "--out", out_dir]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=600)
        path = Path(out_dir) / "qwen2-72b__train_4k__pod16x16.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
    if rec.get("status") != "ok":
        say(run.stdout[-2000:], run.stderr[-4000:])
        raise AssertionError(f"dry-run failed: {rec.get('error')}")
    say(f"[launch] dry-run `{' '.join(cmd[2:-2])}` in "
        f"{time.perf_counter() - t0:.1f} s: traced at published widths on a "
        f"256-rank fake group; per device, modelled from the H100 data-sheet "
        f"constants (not measured): peak "
        f"{rec['peak_device_bytes'] / 2**30:.2f} GiB, {rec['hlo_flops']:.4e} "
        f"FLOPs, {rec['hlo_bytes']:.4e} bytes, "
        f"{rec['coll_bytes']:.4e} collective bytes {rec['coll_breakdown']}; "
        f"terms compute {rec['t_compute']:.3f} s, memory "
        f"{rec['t_memory']:.3f} s, collective {rec['t_collective']:.3f} s, "
        f"bottleneck {rec['bottleneck']}; useful ratio "
        f"{rec['useful_ratio']:.4f}; {rec['notes']}")
    assert rec["peak_device_bytes"] > 0 and rec["hlo_flops"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    # the recorder counts local shards: each of 256 ranks holds ~1/256 of
    # the model's work (a ratio near 0.004 would mean global ops counted)
    assert 0.5 < rec["useful_ratio"] <= 1.0, rec["useful_ratio"]
    say(f"[launch] phase {time.perf_counter() - t_phase:.1f} s")


def examples_phase():
    """[examples] the four example twins on the card at small arguments,
    each run as ``python -m`` would run it (its printed lines follow)."""
    import runpy

    t_phase = time.perf_counter()
    runs = [
        ("train_small", ["--steps", "20", "--seq-len", "64", "--batch", "4",
                         "--out", str(ROOT / "build" / "train_small_ckpt")]),
        ("multi_agent_serving", ["--agents", "3", "--rounds", "2",
                                 "--policies", "tokendance,prefix"]),
        # 6 agents: the capacity model's queueing term admits none of 3
        # at the default SLO (a round's load is 1.2 / n of the server)
        ("slo_admission", ["--agents", "6", "--rounds", "2"]),
        ("continuous_serving", ["--agents", "4", "--rounds", "2",
                                "--stagger", "0,8"]),
    ]
    argv = sys.argv
    try:
        for name, args in runs:
            say(f"[examples] python -m repro_torch.examples.{name} "
                f"{' '.join(args)}")
            sys.argv = [name] + args
            runpy.run_module(f"repro_torch.examples.{name}",
                             run_name="__main__")
            sys.stdout.flush()
    finally:
        sys.argv = argv
    say(f"[examples] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------- phase 6
def smoke_parity(dev):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.rounds import generate_trace
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev)

    for arch, policy in (("qwen2.5-7b", "tokendance"),
                         ("qwen2.5-7b", "prefix"),
                         ("hymba-1.5b", "tokendance"),
                         ("qwen2.5-14b", "tokendance"),
                         ("qwen3-4b", "tokendance"),
                         ("qwen2-72b", "tokendance"),
                         ("gemma3-1b", "tokendance"),
                         ("gemma3-12b", "tokendance"),
                         ("grok-1-314b", "tokendance"),
                         ("arctic-480b", "tokendance"),
                         ("mamba2-2.7b", "tokendance"),
                         ("musicgen-large", "tokendance"),
                         ("chameleon-34b", "tokendance")):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        cpu_params = init_params(cfg, 0, device="cpu")
        gpu_params = to_dev(cpu_params)
        out = {}
        for name, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            eng = ServingEngine(params, cfg, policy, gen_len=32,
                                recompute_ratio=0.1, keep_logits=True)
            out[name] = eng.serve(generate_trace(
                "generative_agents", 3, 3, cfg.vocab_size, seed=11,
                jitter_hist=False))
        worst = 0.0
        for c, g in zip(out["cpu"], out["cuda"]):
            np.testing.assert_array_equal(g.outputs, c.outputs)
            err = float(np.abs(g.first_logits - c.first_logits).max())
            assert err <= 1e-3, (arch, c.round_idx, err)
            worst = max(worst, err)
            assert json.dumps(g.reuse, sort_keys=True, default=str) == \
                json.dumps(c.reuse, sort_keys=True, default=str), c.round_idx
        say(f"[smoke] f32 {cfg.name} engine ({eng.policy.name}), cuda vs "
            f"cpu: greedy tokens and reuse ledgers equal in "
            f"{len(out['cpu'])} rounds x 3 agents, max |logit diff| "
            f"{worst:.3g} (atol 1e-3)")


# ------------------------------------------------------------- phase 7
def hold_restores(tag, dev, timer, master_k, master_v, packs, maps, theta,
                  dtypes, dense=None, what=""):
    """Both restore kernels on one family: ``packs`` maps "aligned" and
    "shifted" to (diff_k, diff_v, diff_slot, delta_pos) in the family
    layout, ``maps`` the pages [M, nb]. For each dtype: the family kernel
    (ONE launch) and the per-mirror kernel (M launches) against the plain
    version into fresh pools — exact in aligned frames, V exact and K
    within the tolerance in shifted ones — and, aligned, CUDA-event times
    of (a) the family kernel, (b) the M per-mirror launches summed, their
    plain versions and their bounds, and (c) ``dense(dt)`` where given;
    ``what`` heads the printed line. Returns (errs, times)."""
    from repro_torch.kernels import ops, ref

    L, S, KV, hd = master_k.shape
    M, nb = maps.shape
    bt = S // nb
    assert nb * bt == S, (S, bt)

    def pools(dt):
        pk = torch.zeros((L, M * nb, bt, KV, hd), dtype=dt, device=dev)
        return pk, torch.zeros_like(pk)

    def inputs(dt, pk):
        kb = master_k.reshape(L, nb, bt, KV, hd).to(dt).contiguous()
        vb = master_v.reshape(L, nb, bt, KV, hd).to(dt).contiguous()
        return (kb, vb, pk[0].to(dt), pk[1].to(dt), pk[2], maps, pk[3])

    def dev_maps(a):
        return [torch.as_tensor(x, device=dev) for x in a]

    def family_plain(x, out):
        return ref.fused_family_restore_ref(*x[:4], *dev_maps(x[4:]), theta,
                                            *out)

    def mirror_plain(x, out):
        for m in range(M):
            out = ref.fused_diff_restore_ref(
                x[0], x[1], x[2][m], x[3][m],
                *dev_maps((x[4][m], x[5][m], x[6][m])), theta, *out)
        return out

    def launchers(x, out_family, out_mirror):
        fam = ops.restore_launcher("fused_family_restore", *x, theta,
                                   *out_family)
        per = [ops.restore_launcher(
            "fused_diff_restore", x[0], x[1], x[2][m:m + 1], x[3][m:m + 1],
            x[4][m:m + 1], x[5][m:m + 1], x[6][m:m + 1], theta, *out_mirror)
            for m in range(M)]
        return fam, per

    # bytes the family restore must move: the Master blocks some mirror
    # takes (no diff there), each mirror's real diff rows and its nb pages
    # written, K and V over all layers; plus the maps and the frequency
    # table. Per mirror, each launch reads nb blocks and writes nb pages.
    blk = L * bt * KV * hd
    slot = packs["aligned"][2]
    need_master = int((slot < 0).any(axis=0).sum())
    n_diff = int((slot >= 0).sum())
    map_b = 4 * (2 * M * nb + M * nb * bt) + 4 * hd // 2

    errs, times = {}, {}
    for dt in dtypes:
        item = torch.tensor([], dtype=dt).element_size()
        for name in ("aligned", "shifted"):
            x = inputs(dt, packs[name])
            want = family_plain(x, pools(dt))
            fam, per = launchers(x, pools(dt), pools(dt))
            got_f = fam()
            for f in per:
                got_m = f()
            for kname, got in (("fused_family_restore", got_f),
                               ("fused_diff_restore", got_m)):
                if name == "aligned":
                    assert torch.equal(got[0], want[0]) and \
                        torch.equal(got[1], want[1]), (tag, kname, dt)
                    errs[(kname, dt)] = 0.0
                else:
                    assert torch.equal(got[1], want[1]), (tag, kname, dt)
                    errs[(kname, dt, "shifted")] = check(kname, got[0],
                                                         want[0], dt)
            if name != "aligned":
                continue
            assert torch.equal(mirror_plain(x, pools(dt))[0], want[0])
            out = pools(dt)
            fam, per = launchers(x, out, out)
            times[dt] = dict(
                family=timer(fam),
                mirror=timer(lambda: [f() for f in per]),
                family_plain=timer(lambda: family_plain(x, out)),
                mirror_plain=timer(lambda: mirror_plain(x, out)),
                family_bound=bound(2 * blk * item * (need_master + n_diff
                                                     + M * nb) + map_b,
                                   0, dt),
                mirror_bound=bound(M * 2 * blk * item * 2 * nb + map_b, 0,
                                   dt))
            if dense is not None and dt == master_k.dtype:
                times[dt]["dense"] = timer(dense(dt))
            del x, want, got_f, got_m, out, fam, per
        tm = times[dt]
        say(f"[{tag}] {what}{dt}: (a) family kernel {tm['family']:.4f} ms "
            f"(bound {tm['family_bound'][0]:.4f}), (b) {M} per-mirror "
            f"launches {tm['mirror']:.4f} ms (bound "
            f"{tm['mirror_bound'][0]:.4f}), (c) dense torch path "
            f"{tm.get('dense', float('nan')):.4f} ms; plain versions "
            f"family {tm['family_plain']:.4f} / per mirror "
            f"{tm['mirror_plain']:.4f} ms; shifted-frame max abs err "
            f"family {errs[('fused_family_restore', dt, 'shifted')]:.3g} / "
            f"per mirror {errs[('fused_diff_restore', dt, 'shifted')]:.3g}")
    torch.cuda.empty_cache()
    return errs, times


def restore_walk(dev, arch, priv_len, block, tag, call=None):
    """The storage walkthrough of ``arch`` at full width (bf16 weights,
    random from seed 0): 8 agents, a private prefix of ``priv_len``, one
    128-token shared block each, collective recovery at ``block_select``
    ``block``, Master + 7 mirrors restored three ways (family kernel: ONE
    launch; per-mirror kernel: 7; dense torch path), bit-equal; counts
    zeroed just before and read just after. Then both restore kernels on
    that family against their plain versions (``hold_restores``). Returns
    their kernel-table rows (with ``call``, where given)."""
    from repro_torch.configs import get_config
    from repro_torch.core.diff_store import MirrorDiff, MirrorHandle, \
        pack_family
    from repro_torch.core.restore import dense_restore_paged
    from repro_torch.examples.compression_demo import group_tokens, \
        walkthrough
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    cfg = get_config(arch)
    params = init_params(cfg, 0, device=dev)
    tokens = group_tokens(cfg.vocab_size, 8, priv_len=priv_len,
                          block_len=128, seed=1)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    wt = walkthrough(params, cfg, tokens, priv_len, ratio=0.05,
                     block_select=block, log=lambda *a: say(f"[{tag}]", *a))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    plain = dict(ops.PLAIN_CALLS)
    say(f"[{tag}] walkthrough {wall:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, launches "
        f"{launches}, plain-version calls {plain}")
    M = len(wt.handles)
    assert M == 7, M
    missing = [k for k in ("rope_align", "block_diff", "flash_prefill",
                           "fused_diff_restore", "fused_family_restore")
               if launches[k] == 0]
    assert not missing, f"kernels never launched on the restore path: " \
        f"{missing}"
    assert launches["fused_family_restore"] == 1, launches
    assert launches["fused_diff_restore"] == M, launches
    assert not any(plain.values()), f"plain versions ran: {plain}"
    st = wt.stats
    say(f"[{tag}] compression: {st['n_caches']} caches, dense "
        f"{st['dense_bytes']} B, stored {st['stored_bytes']} B, family "
        f"{st['compression_ratio']:.4f}x, per mirror "
        f"{st['per_mirror_ratio']:.4f}x, changed blocks "
        f"{[h.diff.n_blocks for h in wt.handles]} of {st['total_blocks']}")
    del params
    torch.cuda.empty_cache()

    theta = cfg.rope_theta
    L, S, KV, hd = wt.master.k.shape
    bt = wt.handles[0].diff.block_tokens
    assert bt == block, (bt, block)
    nb = S // bt
    maps = wt.slot_maps
    shifted = []
    rng = np.random.default_rng(0)
    for h in wt.handles:
        d = h.diff
        new = (d.old_pos + rng.integers(1, 2000, d.old_pos.shape)).astype(
            np.int32)
        shifted.append(MirrorHandle(h.master, MirrorDiff(
            d.rid, d.master_rid, d.block_idx, d.k_vals, d.v_vals, d.old_pos,
            new, d.seq_len, bt)))
    packs = {name: (pk.diff_k, pk.diff_v, pk.diff_slot, pk.delta_pos)
             for name, pk in (("aligned", pack_family(wt.handles)),
                              ("shifted", pack_family(shifted)))}

    def dense(dt):
        out = (torch.zeros((L, M * nb, bt, KV, hd), dtype=dt, device=dev),
               torch.zeros((L, M * nb, bt, KV, hd), dtype=dt, device=dev))
        return lambda: [dense_restore_paged(h, theta, maps[m], *out)
                        for m, h in enumerate(wt.handles)]

    errs, times = hold_restores(tag, dev, Timer(dev), wt.master.k,
                                wt.master.v, packs, maps, theta,
                                (torch.float32, torch.bfloat16), dense)
    dt = wt.master.k.dtype
    tm = times[dt]
    shape = [M, L, nb, bt, KV, hd]
    rows = []
    for name, key in (("fused_diff_restore", "mirror"),
                      ("fused_family_restore", "family")):
        row = dict(
            name=name, shape=shape, max_abs_err=errs[(name, dt)],
            max_abs_err_f32=errs[(name, torch.float32)],
            ms=tm[key], plain_ms=tm[key + "_plain"],
            bound_ms=tm[key + "_bound"][0], bound_by=tm[key + "_bound"][1],
            library_ms=None, launches=launches[name])
        if call:
            row["call"] = call
        rows.append(row)
    return rows


#: synthetic families past one 1024-thread block a tile (and Gemma3-12B's
#: heads): (what, layers, prompt, block, KV heads, head dim, dtype)
RESTORE_SHAPES = (
    ("Gemma3-1B widths, bt 64 (2048 pairs a tile)", 26, 1088, 64, 1, 256,
     torch.float32),
    ("Qwen2.5-7B widths, bt 128 (2048 pairs)", 28, 1024, 128, 4, 128,
     torch.float32),
    ("Gemma3-1B widths, bt 128 (2048 pairs)", 26, 1024, 128, 1, 256,
     torch.bfloat16),
    ("Gemma3-12B widths, 12 of 48 layers, bt 32 (1024 pairs)", 12, 1088, 32,
     8, 256, torch.float32),
)


def restore_shapes(dev):
    """[restore shapes]: both restore kernels on synthetic families of 7
    mirrors at ``RESTORE_SHAPES`` (master, diffs from a seeded generator;
    a third of the blocks changed a mirror), held and timed by
    ``hold_restores`` in the listed dtype (lines, not kernel-table rows:
    no path makes these calls)."""
    t_phase = time.perf_counter()
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(31)
    r = np.random.default_rng(31)
    M = 7
    for what, L, S, bt, KV, hd, dt in RESTORE_SHAPES:
        nb = S // bt
        ndb = max(1, nb // 3)
        mk, mv = (torch.randn(L, S, KV, hd, generator=g, device=dev).to(dt)
                  for _ in range(2))
        dk, dv = (torch.randn(M, L, ndb, bt, KV, hd, generator=g,
                              device=dev).to(dt) for _ in range(2))
        slot = np.full((M, nb), -1, np.int32)
        for m in range(M):
            slot[m, r.choice(nb, ndb, replace=False)] = np.arange(ndb)
        maps = r.permutation(M * nb).reshape(M, nb).astype(np.int32)
        packs = {"aligned": (dk, dv, slot, np.zeros((M, nb, bt), np.int32)),
                 "shifted": (dk, dv, slot,
                             r.integers(1, 2000, (M, nb, bt)).astype(
                                 np.int32))}
        hold_restores("restore shapes", dev, timer, mk, mv, packs, maps, 1e6,
                      (dt,), what=f"{what}, M {M}, {L} layers, nb {nb}, ")
        del mk, mv, dk, dv, packs
    torch.cuda.empty_cache()
    say(f"[restore shapes] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------- [mixed matmul]
#: (model, d_model, d_ff, KV * hd, vocab) of the benchmark's two models
MIXED_MODELS = (("qwen2.5-7b", 3584, 18944, 512, 152064),
                ("qwen2.5-14b", 5120, 13824, 1024, 152064))
#: the rows of each cell's f32 products: decode (the batch), recovery's
#: largest fresh call (B x S) and largest selected call (B x n_sel)
MIXED_CELLS = (("qwen2.5-7b.society-a32", "qwen2.5-7b", 16, 22528, 4096),
               ("qwen2.5-14b.society-a16", "qwen2.5-14b", 8, 7168, 1536),
               ("qwen2.5-7b.genagents-a8", "qwen2.5-7b", 8, 4864, 1024))
#: (M, K, N) off the cells' shapes: one row, 17 rows (past the streaming
#: tile), ragged K and N (multiples of 8, not of any tile)
MIXED_EDGES = ((1, 3584, 512), (17, 1024, 1000), (64, 1000, 520),
               (65, 3584, 3584), (16, 200, 4104), (300, 4104, 200))


def mixed_bound(M, K, N):
    """The least time of an [M, K] x [K, N] mixed product in ms, and what
    sets it: the bf16 weight, f32 x and f32 out moved once at 3.35 TB/s,
    or three bf16 products at 989 TFLOP/s."""
    n_bytes = 2 * K * N + 4 * M * K + 4 * M * N
    flops = 2 * M * K * N
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, 3 * flops / PEAK_FLOPS[
        torch.bfloat16]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def mixed_step(dev, g, M):
    """CUDA-event time of a Qwen2.5-7B decode step's products back to back
    (wq, wk, wv, wo, gate, up, down on each of 28 layers' own seeded
    weights, then lm_head: 14.14 GB of bf16, so each product reads its
    weight from HBM), by the kernel and by the parent's path. The device
    sleeps first while the host enqueues the step, so the events time
    the device's work, not the host's launches. Median of 5; with the
    kernel's launches in one step, counted."""
    from repro_torch.kernels import ops

    _, D, F_, KVH, V = MIXED_MODELS[0]
    shapes = ((D, D), (D, KVH), (D, KVH), (D, D), (D, F_), (D, F_), (F_, D))
    ws = [[(torch.randn(K, N, generator=g, device=dev) * 0.02).bfloat16()
           for K, N in shapes] for _ in range(28)]
    head = (torch.randn(D, V, generator=g, device=dev) * 0.02).bfloat16()
    xd = torch.randn(M, D, generator=g, device=dev)
    xf = torch.randn(M, F_, generator=g, device=dev)
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)

    def run(prod):
        for layer in ws:
            for w in layer[:6]:
                prod(xd, w)
            prod(xf, layer[6])
        prod(xd, head)

    n0 = ops.LAUNCHES["mixed_matmul"]
    run(ops.mixed_matmul)
    launches = ops.LAUNCHES["mixed_matmul"] - n0
    times = {}
    for name, prod in (("kernel", ops.mixed_matmul),
                       ("parent", lambda x, w: x @ w.float())):
        run(prod)
        got = []
        for _ in range(5):
            flush.sum()
            torch.cuda._sleep(40_000_000)       # ~23 ms at 1.75 GHz
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            run(prod)
            e.record()
            e.synchronize()
            got.append(s.elapsed_time(e))
        times[name] = statistics.median(got)
    w_bytes = 2 * (sum(w.numel() for w in ws[0]) * 28 + head.numel())
    del ws, head
    return times, w_bytes, launches


def mixed_case(timer, g, M, K, N, timed=True):
    """One mixed product on seeded inputs: the kernel against the plain
    product (TF32 off), twice for the same bits; with ``timed`` its time,
    the parent's path's (the weight cast to f32, then cuBLAS's f32
    product) and its bound."""
    from repro_torch.kernels import ops, ref

    dev = g.device
    x = torch.randn(M, K, generator=g, device=dev)
    w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).bfloat16()
    got = ops.mixed_matmul(x, w)
    assert torch.equal(got, ops.mixed_matmul(x, w)), (M, K, N)
    want = ref.mixed_matmul_ref(x, w)
    err = check("mixed_matmul", got, want, torch.float32)
    r = dict(M=M, K=K, N=N, err=err)
    if timed:
        r.update(ms=timer(lambda: ops.mixed_matmul(x, w)),
                 parent_ms=timer(lambda: x @ w.float()))
        r["bound_ms"], r["bound_by"] = mixed_bound(M, K, N)
    return r


#: (M, K, N) where the mixed product's error against the float64 product
#: is held to cuBLAS f32's: a decode step's down projection, a recovery's
#: wq
MIXED_EXACT = ((16, 18944, 3584), (4096, 3584, 3584))


def mixed_exactness(g, M, K, N):
    """Max abs error against the product in float64 of the kernel and of
    the parent's path (the weight cast to f32, cuBLAS's f32 product, TF32
    off) on seeded inputs, and the largest sum of |x| |w| of an output."""
    from repro_torch.kernels import ops

    dev = g.device
    x = torch.randn(M, K, generator=g, device=dev)
    w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).bfloat16()
    exact = x.double() @ w.double()
    scale = (x.double().abs() @ w.double().abs()).max().item()
    errs = [(got.double() - exact).abs().max().item()
            for got in (ops.mixed_matmul(x, w), x @ w.float())]
    return errs[0], errs[1], scale


def mixed_phase(dev):
    """[mixed matmul]: ``ops.mixed_matmul`` at every f32 product shape of
    the benchmark's three cells (decode at the batch's rows, recovery at
    its largest fresh and selected calls; lm_head at the batch's rows)
    and at edge shapes: each against the plain product and twice for
    the same bits, timed beside the parent's cast-plus-cuBLAS path on the
    same inputs and its bound; inf and NaN in x propagate as in the
    plain product; at ``MIXED_EXACT`` no further from the float64
    product than 1.5 times the parent's path. Then the sum of a 7B decode
    step's products (7 a layer x 28 layers + lm_head) against the bound
    of its weight bytes.
    Returns the kernel table's row (the 7B decode step)."""
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    timer = ReadTimer(dev)
    g = torch.Generator(device=dev).manual_seed(33)
    t_phase = time.perf_counter()
    for M, K, N in MIXED_EDGES:
        r = mixed_case(timer, g, M, K, N, timed=False)
        say(f"[mixed matmul] edge M {M} K {K} N {N}: max abs err "
            f"{r['err']:.3g}, bit-equal twice")
    x = torch.randn(24, 1024, generator=g, device=dev)
    x[3, 5], x[7, 0], x[20, 1000] = float("inf"), float("nan"), \
        -float("inf")
    w = (torch.randn(1024, 256, generator=g, device=dev) * 0.03).bfloat16()
    for rows in (x[:16], x):
        got, want = ops.mixed_matmul(rows, w), rows @ w.float()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        assert torch.allclose(got[fin], want[fin], atol=1e-4, rtol=1e-4)
    say("[mixed matmul] inf and NaN in x: the plain product's inf and NaN "
        "cells, both tiles")
    # no less exact than the f32 product it replaces: a split of x into two
    # bf16 parts (16 bits) or split TF32 (22) would miss this by far
    for M, K, N in MIXED_EXACT:
        err, cublas, scale = mixed_exactness(g, M, K, N)
        say(f"[mixed matmul] exactness M {M} K {K} N {N}: max abs err "
            f"against float64 {err:.3g} (parent path {cublas:.3g}; "
            f"{err / scale:.3g} of the largest sum of |x| |w|)")
        assert err <= 1.5 * cublas, (M, K, N, err, cublas)
    step = {}
    rows = []
    for cell, model, dec, fresh, sel in MIXED_CELLS:
        _, D, F_, KVH, V = next(m for m in MIXED_MODELS if m[0] == model)
        prods = {"wq/wo": (D, D), "wk/wv": (D, KVH), "gate/up": (D, F_),
                 "down": (F_, D)}
        for M in (dec, fresh, sel):
            for name, (K, N) in prods.items():
                key = (model, M, K, N)
                if key in step:
                    continue
                r = mixed_case(timer, g, M, K, N)
                step[key] = r
                rows.append(r)
                say(f"[mixed matmul] {cell} {name} M {M} K {K} N {N}: "
                    f"{r['ms']:.4f} ms (parent path {r['parent_ms']:.4f}, "
                    f"bound {r['bound_ms']:.4f} by {r['bound_by']}, "
                    f"{r['bound_ms'] / r['ms'] * 100:.1f} % of it), max "
                    f"abs err {r['err']:.3g}")
                assert r["ms"] < r["parent_ms"], r
        key = (model, dec, D, V)
        if key not in step:
            r = mixed_case(timer, g, dec, D, V)
            step[key] = r
            rows.append(r)
            say(f"[mixed matmul] {cell} lm_head M {dec} K {D} N {V}: "
                f"{r['ms']:.4f} ms (parent path {r['parent_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} by {r['bound_by']}, "
                f"{r['bound_ms'] / r['ms'] * 100:.1f} % of it), max abs err "
                f"{r['err']:.3g}")
            assert r["ms"] < r["parent_ms"], r
    # one 7B decode step: wq, wk, wv, wo, gate, up, down a layer, lm_head
    _, D, F_, KVH, V = MIXED_MODELS[0]
    layer = ((D, D), (D, KVH), (D, KVH), (D, D), (D, F_), (D, F_), (F_, D))
    for M in (16, 8):
        summed = 28 * sum(step[("qwen2.5-7b", M, K, N)]["ms"]
                          for K, N in layer)
        summed += step[("qwen2.5-7b", M, D, V)]["ms"]
        t, w_bytes, launches = mixed_step(dev, g, M)
        assert launches == 28 * 7 + 1, launches
        ms, parent = t["kernel"], t["parent"]
        b_ms = w_bytes / HBM_BYTES_PER_S * 1e3
        say(f"[mixed matmul] qwen2.5-7b decode step at M {M}: the products "
            f"back to back {ms:.3f} ms (parent path {parent:.3f}; the "
            f"single calls' times summed {summed:.3f}), bound of the "
            f"{w_bytes / 1e9:.2f} GB of weights {b_ms:.3f} ms, "
            f"{b_ms / ms * 100:.1f} % of it; {launches} launches")
        if M == 16:
            row = dict(name="mixed_matmul", call="7B decode step, M 16",
                       shape="28 x 7 products + lm_head, Qwen2.5-7B", ms=ms,
                       plain_ms=parent, library_ms=None, bound_ms=b_ms,
                       bound_by="bytes", max_abs_err=max(
                           r["err"] for r in rows),
                       max_abs_err_f32=max(r["err"] for r in rows),
                       launches=launches)
    say(f"[mixed matmul] phase {time.perf_counter() - t_phase:.1f} s")
    return row


def restore(dev):
    """[restore]: the storage walkthrough at Qwen2.5-7B (blocks of 32) and
    at Gemma3-1B (head dim 256, f32 recovery, blocks of 64: 2048 (token,
    16-byte chunk) pairs a tile), each with its kernel-table rows, then
    the synthetic shapes."""
    rows = restore_walk(dev, "qwen2.5-7b", 32, 32, "restore")
    rows += restore_walk(dev, "gemma3-1b", 64, 64, "restore gemma3-1b",
                         call="gemma3-1b block 64")
    restore_shapes(dev)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = card()
    build()
    launches, kept, priv, n_heads, split, rope_split, qwen = main_path(dev)
    table = kernels(dev, launches, kept, split, rope_split)
    table += table_rows([paged_prefill(dev, priv, n_heads)])
    del priv
    table += table_rows([prefix(dev, qwen)])
    slo(qwen)
    continuous(qwen)
    table += table_rows(pages_phase(dev, qwen))
    page_edges(dev)
    heads_phase(dev)
    heads_serve(dev)
    forward_phase(dev, qwen)
    before = torch.cuda.memory_allocated()
    weights = nbytes(*tensors(qwen["params"]))
    del qwen
    freed("qwen2.5-7b", before, weights)
    # [serve 112]: the main path's model with 32 query heads over 4 at head
    # dim 112 (3584 = 32 x 112, G 8: the main path's weight sizes)
    table += table_rows(model_phase(dev, "qwen2.5-7b", dense=True, binds=[],
                                    heads=SERVE_112, tag="serve 112"))
    table += table_rows(model_phase(dev, "qwen2.5-14b", binds=[]))
    table += table_rows(model_phase(dev, "qwen3-4b", timed=False,
                                    dense=True, binds=[]))
    table += table_rows(model_phase(dev, "qwen2-72b", n_layers=20, binds=[]))
    # Gemma3: 1B's window of 512 binds at rounds 1 and 2 (544 and 576
    # rows), so [gemma3-1b dense] holds the paged kernel's window bit for
    # bit against the dense kernel's; 12B's window of 1024 never binds
    table += table_rows(model_phase(dev, "gemma3-1b", timed=False,
                                    dense=True, binds=[1, 2]))
    table += table_rows(model_phase(dev, "gemma3-12b", binds=[]))
    gemma_edges(dev)
    # the last five families: Grok-1 (4 of 64 layers; MoE, every attention
    # call capped at 30) on both decode loops; Arctic (2 of 35 layers, 128
    # experts, dense residual) with check_layer 0 so that one layer is
    # fresh and one selective; Mamba2 (no attention); MusicGen (G 1) and
    # Chameleon (24 of 48 layers) with frontend embeddings
    table += table_rows(model_phase(dev, "grok-1-314b", n_layers=4,
                                    dense=True, binds=[]))
    table += table_rows(model_phase(dev, "arctic-480b", n_layers=2,
                                    timed=False, binds=[],
                                    engine_kw=dict(check_layer=0)))
    ssm_phase(dev)
    table += table_rows(model_phase(dev, "musicgen-large", timed=False,
                                    binds=[], embeds=True))
    table += table_rows(model_phase(dev, "chameleon-34b", n_layers=24,
                                    timed=False, binds=[], embeds=True))
    softcap_edges(dev)
    hlaunches, hkept = hybrid(dev)
    hybrid_prefill(dev, hkept)
    table += table_rows([decode_kernel(dev, hlaunches, hkept,
                                       kept["flash_decode_dense"])])
    del hkept
    train_launches = train_phase(dev)
    table += table_rows([train_kernel(dev,
                                      train_launches["flash_prefill_bwd"])])
    train_parity(dev)
    # [train heads]: Qwen3-4B at Phi-3-mini's heads, 32 over 32 at hd 96
    _, H, KV, hd = TRAIN_HEAD_LAYOUTS[1]
    heads_launches = train_phase(
        dev, dict(n_heads=H, n_kv_heads=KV, head_dim=hd), "train heads",
        n_train=0)
    assert heads_launches == train_launches, (heads_launches,
                                              train_launches)
    for model, H, KV, hd in TRAIN_HEAD_LAYOUTS:
        train_parity(dev, dict(n_heads=H, n_kv_heads=KV, head_dim=hd),
                     f"train heads parity {model}")
    examples_phase()
    launch_phase(dev)
    smoke_parity(dev)
    table += table_rows(restore(dev))
    table += table_rows([mixed_phase(dev)])
    say(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
    say(smi)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
