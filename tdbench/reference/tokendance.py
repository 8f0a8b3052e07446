"""Plain float32 reference of the served semantics: TokenDance at the
serving engine's defaults, in plain PyTorch, with no kernel, pool or
batching of the program.

It replays one episode of All-Gather rounds from the inputs the benchmark
hands to both sides (weights, histories, tasks) and the program's served
tokens, which it judges:

* Round 0 computes every prompt from scratch. A round's decode is taken
  teacher-forced on the served tokens: token t+1 is predicted from the
  prompt's KV and served tokens 0..t, as a greedy decode over a cache does.
  The last served token is never fed, so its cached K/V rows are zeros.
* From round 1 an agent's prompt is its history, every agent's previous
  output (one shared block each) and its task, each padded to whole
  32-token blocks. Cached K/V: the history's rows as the agent's previous
  round left them (Master-Mirror storage is lossless: every block that
  differs is kept), its own previous output as that round decoded it, and
  each shared block as its producer decoded it, the keys rotated from
  where they were computed to where they now sit. Outputs are found by
  their tokens; of equal outputs the one stored last is used.
* Recovery runs layers 0..check_layer fresh over the whole prompt, scores
  each cached position by the squared change of its check-layer key,
  selects whole blocks (every block holding a fresh token or the last
  token, then the highest-scoring cached blocks, ``ratio`` of them,
  rounded up), and recomputes only the selected rows through the later
  layers, attending over the cached rows merged with the recomputed ones.
  Layers up to the check layer keep the cached rows where not selected.

The block selection is discrete: a near-tie in the scores can flip a
block between two sound computations. So the reference follows the
selection it is given (the program's) and reports how far that selection
lies from its own: ``sel_rel``, the largest relative score gap between a
block it would have chosen and one it was given instead (0 where the two
agree). A model with ``quant="fp8"`` rounds every matrix product's and
attention's operands to float8 e4m3 (per row, per column), the control of
the comparison.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1.0e30
FP8_MAX = 448.0


def fq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along the
    other dims (the largest magnitude maps to 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Model:
    """The decoder's equations in float32 over the benchmark's flat
    weights (any stored dtype; cast a layer at a time)."""

    def __init__(self, w: Dict[str, torch.Tensor], s: dict,
                 quant: Optional[str] = None):
        assert quant in (None, "fp8")
        self.w, self.s, self.quant = w, s, quant
        half = s["hd"] // 2
        dev = w["embed"].device
        self.freqs = 1.0 / (s["theta"] ** (torch.arange(
            half, dtype=torch.float32, device=dev) / half))

    def mat(self, name: str, l: Optional[int] = None) -> torch.Tensor:
        t = (self.w[name] if l is None else self.w[name][l]).float()
        if self.quant and t.dim() == 2:
            t = fq(t, 0)
        return t

    def layer(self, l: int) -> dict:
        return {k: self.mat(k, l) for k in ("ln1", "ln2", "wq", "bq", "wk",
                                            "bk", "wv", "bv", "wo", "w_gate",
                                            "w_up", "w_down")}

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (fq(x, -1) if self.quant else x) @ w

    def rms(self, x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.s["eps"]) * (1.0 + off)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Rotate ``x`` ``[..., S, nh, hd]`` to positions ``pos`` ``[...,
        S]`` (split halves)."""
        ang = pos.float()[..., None] * self.freqs
        c, s_ = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s_, x2 * c + x1 * s_], dim=-1)

    def qkv(self, W: dict, h: torch.Tensor, pos: torch.Tensor):
        """q ``[..., S, H, hd]``, k/v ``[..., S, KV, hd]`` of rows ``h`` at
        positions ``pos``."""
        s = self.s
        x = self.rms(h, W["ln1"])
        q = (self.mm(x, W["wq"]) + W["bq"]).unflatten(-1, (s["H"], s["hd"]))
        k = (self.mm(x, W["wk"]) + W["bk"]).unflatten(-1, (s["KV"], s["hd"]))
        v = (self.mm(x, W["wv"]) + W["bv"]).unflatten(-1, (s["KV"], s["hd"]))
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               qpos: torch.Tensor) -> torch.Tensor:
        """One sequence: queries ``[Sq, H, hd]`` at ``qpos`` over keys
        ``[Sk, KV, hd]`` whose row j sits at position j (causal)."""
        if self.quant:
            q, k, v = fq(q, -1), fq(k, -1), fq(v, -1)
        Sq, H, hd = q.shape
        Sk, KV = k.shape[0], k.shape[1]
        qg = q.reshape(Sq, KV, H // KV, hd)
        sc = torch.einsum("qkgd,skd->kgqs", qg, k) / math.sqrt(hd)
        allowed = (torch.arange(Sk, device=q.device)[None, :]
                   <= qpos[:, None])
        sc = sc.masked_fill(~allowed, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        return torch.einsum("kgqs,skd->qkgd", p, v).reshape(Sq, H * hd)

    def finish(self, W: dict, h: torch.Tensor, o: torch.Tensor):
        """Output projection, then the SwiGLU MLP, on the residual."""
        h = h + self.mm(o, W["wo"])
        x = self.rms(h, W["ln2"])
        a = F.silu(self.mm(x, W["w_gate"])) * self.mm(x, W["w_up"])
        return h + self.mm(a, W["w_down"])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        x = self.rms(h, self.mat("final_norm"))
        return self.mm(x, self.mat("lm_head"))


def pad_block(t: np.ndarray, bt: int, sep: int) -> np.ndarray:
    pad = (-len(t)) % bt
    return np.concatenate([t, np.full(pad, sep, np.int32)]).astype(np.int32)


def n_sel_blocks(fresh: np.ndarray, bt: int, ratio: float) -> int:
    """Blocks recomputed: every block with a fresh token or the last token,
    then ``ratio`` of the others, rounded up (at least one)."""
    fm = np.pad(np.asarray(fresh, bool).copy(), (0, (-len(fresh)) % bt))
    fm[len(fresh) - 1] = True
    blocks = fm.reshape(-1, bt).any(axis=1)
    n_fresh = int(blocks.sum())
    nb = n_fresh + max(1, math.ceil(ratio * (blocks.size - n_fresh)))
    return min(nb, blocks.size)


def sel_rel(bscores: np.ndarray, given: np.ndarray, nb: int) -> float:
    """How far a given block set lies from the top ``nb`` by ``bscores``
    (stable, ties to the lower index): 0 where they agree, else the
    largest relative gap between a block left out and one taken in."""
    own = np.argsort(-bscores, kind="stable")[:nb]
    out_ = np.setdiff1d(own, given)
    in_ = np.setdiff1d(given, own)
    if out_.size == 0 and in_.size == 0:
        return 0.0
    hi = float(bscores[out_].max()) if out_.size else 0.0
    lo = float(bscores[in_].min()) if in_.size else 0.0
    if in_.size == 0 or out_.size == 0 or hi <= 0:
        return 1.0      # a wrong count of blocks
    return max(0.0, (hi - lo) / hi)


def _gaps(lg: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Per row: best logit minus the logit of ``toks``."""
    return lg.max(dim=-1).values - lg.gather(-1, toks[..., None])[..., 0]


def simulate(model: Model, ep, outputs: List[Dict[str, np.ndarray]],
             given_sel: Optional[List[Dict[str, np.ndarray]]] = None, *,
             bt: int = 32, check_layer: int = 1, ratio: float = 0.15,
             extra: Optional[Dict[tuple, np.ndarray]] = None,
             keep_argmax: bool = False) -> dict:
    """Replay the episode ``ep`` (``tdbench.traffic.Episode``) over its
    rounds ``0..len(outputs)-1``, judging ``outputs[r][agent]`` (the
    served tokens). ``given_sel[r][agent]`` (rounds >= 1) is the selection
    to follow (sorted token positions); without it the reference follows
    its own. ``extra[(r, agent)]`` are other tokens to judge at the same
    positions. Returns the served tokens' gaps, ``sel_rel`` per batch,
    the extra tokens' gaps and, with ``keep_argmax``, the model's own
    first-ranked token at every judged position."""
    s, dev = model.s, model.w["embed"].device
    L, G = s["L"], ep.gen_len
    c = min(check_layer, L - 1)
    sep = ep.sep_id
    aids = ep.agent_ids
    hist_kv: Dict[str, tuple] = {}
    seg: Dict[bytes, tuple] = {}          # output tokens -> (k, v, src)
    gaps, extra_gaps, rels = [], [], []
    argmax: Dict[tuple, np.ndarray] = {}
    for r in range(len(outputs)):
        prompts = {}
        for a in aids:
            hist = np.concatenate([ep.histories[a]]
                                  + [outputs[q][a] for q in range(r)])
            parts = [pad_block(hist, bt, sep)]
            if r:
                parts += [pad_block(outputs[r - 1][j], bt, sep) for j in aids]
            parts.append(pad_block(ep.tasks[r][a], bt, sep))
            prompts[a] = (parts, np.concatenate(parts))
        batches: Dict[int, list] = {}
        for a in aids:
            batches.setdefault(len(prompts[a][1]), []).append(a)
        for S, group in batches.items():
            N = len(group)
            served = torch.as_tensor(np.stack([outputs[r][a] for a in group]),
                                     device=dev).long()
            toks = torch.as_tensor(np.stack([prompts[a][1] for a in group]),
                                   device=dev).long()
            Hlen = len(prompts[group[0]][0][0])
            if r == 0:
                lg, K, V = _full(model, toks, served, G)
            else:
                lg, K, V, rel = _recover(model, toks, served, group, prompts,
                                         Hlen, hist_kv, seg, outputs[r - 1],
                                         aids, None if given_sel is None else
                                         given_sel[r], c, bt, ratio)
                rels.extend(rel)
            gaps.append(_gaps(lg, served).flatten().cpu())
            if extra is not None:
                et = torch.as_tensor(np.stack([extra[(r, a)] for a in group]),
                                     device=dev).long()
                extra_gaps.append(_gaps(lg, et).flatten().cpu())
            if keep_argmax:
                am = lg.argmax(dim=-1).cpu().numpy()
                for i, a in enumerate(group):
                    argmax[(r, a)] = am[i]
            del lg
            # store: the history's rows for the next round, the output's
            # decoded rows (the last one never fed: zeros) under its tokens
            for i, a in enumerate(group):
                hist_kv[a] = (K[:, i, :Hlen].clone(), V[:, i, :Hlen].clone())
                ok = torch.zeros((L, G) + K.shape[3:], device=dev)
                ov = torch.zeros_like(ok)
                ok[:, :G - 1] = K[:, i, S:S + G - 1]
                ov[:, :G - 1] = V[:, i, S:S + G - 1]
                seg[outputs[r][a].astype(np.int32).tobytes()] = (ok, ov, S)
            del K, V
    out = {"gaps": torch.cat(gaps).numpy(), "sel_rel": np.asarray(rels)}
    if extra is not None:
        out["extra_gaps"] = torch.cat(extra_gaps).numpy()
    if keep_argmax:
        out["argmax"] = argmax
    return out


def _layer_full(model: Model, W: dict, h: torch.Tensor, pos: torch.Tensor):
    """One layer over whole sequences ``h`` ``[N, T, D]`` at ``pos``
    ``[T]`` (causal); returns h and the layer's k, v."""
    q, k, v = model.qkv(W, h, pos)
    o = torch.stack([model.attend(q[i], k[i], v[i], pos)
                     for i in range(h.shape[0])])
    return model.finish(W, h, o), k, v


def _full(model: Model, toks, served, G: int):
    """Round 0: prompt and the fed served tokens, from scratch."""
    seq = torch.cat([toks, served[:, :G - 1]], dim=1)
    S = toks.shape[1]
    pos = torch.arange(seq.shape[1], device=seq.device)
    h = model.w["embed"][seq].float()
    Ks, Vs = [], []
    for l in range(model.s["L"]):
        h, k, v = _layer_full(model, model.layer(l), h, pos)
        Ks.append(k)
        Vs.append(v)
    lg = model.logits(h[:, S - 1:])
    return lg, torch.stack(Ks), torch.stack(Vs)


def _recover(model: Model, toks, served, group, prompts, Hlen, hist_kv, seg,
             prev_out, aids, given, c, bt, ratio):
    """Rounds >= 1: the cached rows, recovery, and the teacher-forced
    decode of one batch. Returns logits ``[N, G, V]``, the K/V of the
    prompt and the fed served tokens ``[L, N, S+G-1, KV, hd]``, and the
    batch's ``sel_rel``."""
    s = model.s
    L, dev = s["L"], toks.device
    N, S = toks.shape
    G = served.shape[1]
    KV, hd = s["KV"], s["hd"]
    # ---- cached rows (zeros where fresh), keys rotated to their place ---
    bK = torch.zeros((L, N, S, KV, hd), device=dev)
    bV = torch.zeros_like(bK)
    for j, b in enumerate(aids):
        k, v, src = seg[prev_out[b].astype(np.int32).tobytes()]
        at = Hlen + j * bt
        bK[:, :, at:at + G] = model.rope(k, torch.full((G,), at - src,
                                                       device=dev))[:, None]
        bV[:, :, at:at + G] = v[:, None]
    for i, a in enumerate(group):
        hk, hv = hist_kv[a]
        hp = hk.shape[1]
        assert hp + G == Hlen, (hp, G, Hlen)
        k, v, src = seg[prev_out[a].astype(np.int32).tobytes()]
        bK[:, i, :hp], bV[:, i, :hp] = hk, hv
        bK[:, i, hp:Hlen] = model.rope(k, torch.full((G,), hp - src,
                                                      device=dev))
        bV[:, i, hp:Hlen] = v
    n_cached = Hlen + len(aids) * bt
    cached = torch.zeros(S, dtype=torch.bool, device=dev)
    cached[:n_cached] = True
    # ---- fresh layers, selection --------------------------------------
    pos = torch.arange(S, device=dev)
    h = model.w["embed"][toks].float()
    fk, fv = [], []
    for l in range(c + 1):
        h, k, v = _layer_full(model, model.layer(l), h, pos)
        fk.append(k)
        fv.append(v)
    dk = fk[c] - bK[c]
    dev_ = torch.where(cached, (dk * dk).sum(dim=(-1, -2)), 0.0)
    scores = torch.where(cached, dev_, BIG)
    scores[:, S - 1] += 2 * BIG
    bscores = scores.reshape(N, S // bt, bt).sum(-1).cpu().numpy()
    nb = n_sel_blocks(~cached.cpu().numpy(), bt, ratio)
    rels, sel = [], []
    for i, a in enumerate(group):
        own = np.sort(np.argsort(-bscores[i], kind="stable")[:nb])
        blocks = own if given is None else np.unique(
            np.asarray(given[a]) // bt)
        rels.append(sel_rel(bscores[i], blocks, nb))
        if len(blocks) != nb:       # a wrong count: judged, then own
            blocks = own
        sel.append((blocks[:, None] * bt + np.arange(bt)).ravel())
    sel = torch.as_tensor(np.stack(sel), device=dev).long()    # [N, n_sel]
    rows = torch.arange(N, device=dev)[:, None]
    # ---- recovery through every layer, and the decode ------------------
    dpos = torch.arange(S, S + G - 1, device=dev)
    hd_ = model.w["embed"][served[:, :G - 1]].float()
    h_sel = h[rows, sel]
    Ks, Vs = [], []
    for l in range(L):
        W = model.layer(l)
        kl, vl = bK[l].clone(), bV[l].clone()
        if l <= c:
            kl[rows, sel] = fk[l][rows, sel]
            vl[rows, sel] = fv[l][rows, sel]
        else:
            q, k, v = model.qkv(W, h_sel, sel)
            kl[rows, sel] = k
            vl[rows, sel] = v
            o = torch.stack([model.attend(q[i], kl[i], vl[i], sel[i])
                             for i in range(N)])
            h_sel = model.finish(W, h_sel, o)
        q, k, v = model.qkv(W, hd_, dpos)
        kl, vl = torch.cat([kl, k], dim=1), torch.cat([vl, v], dim=1)
        o = torch.stack([model.attend(q[i], kl[i], vl[i], dpos)
                         for i in range(N)])
        hd_ = model.finish(W, hd_, o)
        Ks.append(kl)
        Vs.append(vl)
    assert bool((sel[:, -1] == S - 1).all())
    lg = model.logits(torch.cat([h_sel[:, -1:], hd_], dim=1))
    return lg, torch.stack(Ks), torch.stack(Vs), rels
