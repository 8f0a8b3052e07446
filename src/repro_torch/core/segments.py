"""Round-aware prompt interface (paper §4.1).

Multi-agent prompts are assembled from logical blocks — a private history,
the shared output blocks of the previous round, and the round task — with a
reserved ``<TTSEP>`` separator token between adjacent blocks. Keeping the
block structure visible lets the runtime switch from fixed-size chunk
hashing to *segment-based* hashing: two prompts containing the same shared
update map it to the same cache object even when their private histories
differ in length.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PRIVATE = "private"
SHARED = "shared"
TASK = "task"


def segment_hash(tokens: Sequence[int]) -> str:
    """Content hash of a token segment (position-independent identity)."""
    arr = np.asarray(tokens, np.int32)
    return hashlib.sha1(arr.tobytes()).hexdigest()


@dataclass(frozen=True)
class Segment:
    """One logical block of a prompt."""

    tokens: Tuple[int, ...]
    kind: str  # PRIVATE | SHARED | TASK

    @property
    def sid(self) -> str:
        return segment_hash(self.tokens)

    def __len__(self) -> int:
        return len(self.tokens)


@dataclass(frozen=True)
class Span:
    """A segment's placement inside one tokenized prompt."""

    start: int          # first token index (inclusive)
    end: int            # last token index (exclusive)
    kind: str
    sid: str

    def __len__(self) -> int:
        return self.end - self.start


@dataclass
class PromptLayout:
    """Tokenized prompt + per-segment spans (separators are not in spans)."""

    tokens: np.ndarray            # int32 [S]
    spans: List[Span]

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])

    def shared_spans(self) -> List[Span]:
        return [s for s in self.spans if s.kind == SHARED]

    def fresh_mask(self, cached_sids: Optional[set] = None) -> np.ndarray:
        """Bool [S]: True where the token must be computed fresh (private,
        task, separators, and shared segments absent from ``cached_sids``)."""
        mask = np.ones(self.length, bool)
        for s in self.spans:
            if s.kind == SHARED and (cached_sids is None or s.sid in cached_sids):
                mask[s.start : s.end] = False
        return mask


def build_prompt(segments: Sequence[Segment],
                 sep_id: Optional[int]) -> PromptLayout:
    """Assemble a prompt with ``<TTSEP>`` separators between blocks.

    ``sep_id=None`` omits physical separators — used with block-aligned
    segments (see :func:`aligned_segment`) where the 32-token block
    boundary itself marks the segment boundary. This is the TPU
    tile-aligned variant of the paper's interface: the runtime still gets
    the block structure (through the spans), but every segment occupies
    whole KV blocks so Mirror diffs stay block-sparse.
    """
    toks: List[int] = []
    spans: List[Span] = []
    for i, seg in enumerate(segments):
        if i and sep_id is not None:
            toks.append(sep_id)
        start = len(toks)
        toks.extend(int(t) for t in seg.tokens)
        spans.append(Span(start, len(toks), seg.kind, seg.sid))
    return PromptLayout(np.asarray(toks, np.int32), spans)


def aligned_segment(tokens: Sequence[int], kind: str, block_tokens: int,
                    pad_id: int) -> Segment:
    """A segment padded to a whole number of KV blocks. The pad tokens are
    part of the segment content (hashed with it), so content identity and
    dedup still hold."""
    toks = [int(t) for t in tokens]
    pad = (-len(toks)) % block_tokens
    toks.extend([pad_id] * pad)
    return Segment(tuple(toks), kind)


def split_prompt(tokens: Sequence[int], sep_id: int) -> List[Tuple[int, int]]:
    """Split a flat token stream at separator boundaries.

    Returns [(start, end)] spans of the segments between separators. This is
    the runtime-side inverse of :func:`build_prompt` for applications that
    submit raw token streams with embedded separators.
    """
    toks = np.asarray(tokens)
    cuts = np.flatnonzero(toks == sep_id)
    spans, prev = [], 0
    for c in cuts:
        if c > prev:
            spans.append((prev, int(c)))
        prev = int(c) + 1
    if prev < len(toks):
        spans.append((prev, len(toks)))
    return spans


@dataclass
class SegmentCacheEntry:
    """Cached KV for one content segment.

    k/v are [L, S_seg, KV, hd] arrays; ``src_pos`` records the absolute
    positions the values were computed at (needed for RoPE realignment).
    """

    sid: str
    k: object           # tensor [L, S, KV, hd]
    v: object
    src_pos: np.ndarray  # int32 [S]
    producer: str = ""
    round_idx: int = -1

    def nbytes(self) -> int:
        return self.k.numel() * self.k.element_size() * 2


@dataclass
class PagedSegmentCacheEntry:
    """Cached KV for one content segment, kept PAGED (paper §4.4 end-to-end).

    Instead of owning a dense ``[L, S_seg, KV, hd]`` tensor, the entry
    references a shared page pool (typically the output of
    ``repro_torch.core.restore.fused_restore_family_shared``, where in-family
    mirrors alias the Master's pages) through a per-entry page table.
    ``KVCollector.collective_reuse`` consumes the pool + ``page_idx``
    directly, so the dense segment is never materialized on the host —
    the restore cost of a shared block stays paid once regardless of how
    many agents reference it.

    Fields:
      pool_k/pool_v: [L, P, bt, KV, hd] shared page pools (one object per
        Master family; entries of one family alias the same arrays).
      page_idx:      int32 [nbh] logical block -> pool page for THIS
        entry's first ``seq_len`` tokens (``nbh = ceil(seq_len / bt)``).
      tail_k/tail_v: optional dense [L, T, KV, hd] suffix appended after
        the paged span (the agent's own freshly-decoded output block —
        irreducible new content that has no pages yet).
      src_pos:       int32 [seq_len + T] absolute source positions for
        RoPE realignment, covering the paged span then the tail.
    """

    sid: str
    pool_k: object            # tensor [L, P, bt, KV, hd]
    pool_v: object
    page_idx: np.ndarray      # int32 [nbh]
    src_pos: np.ndarray       # int32 [seq_len + tail_len]
    seq_len: int              # tokens gathered from pages
    block_tokens: int
    tail_k: object = None     # tensor [L, T, KV, hd] or None
    tail_v: object = None
    producer: str = ""
    round_idx: int = -1

    @property
    def tail_len(self) -> int:
        return 0 if self.tail_k is None else int(self.tail_k.shape[1])

    @property
    def length(self) -> int:
        return self.seq_len + self.tail_len

    @classmethod
    def prefix_extension(cls, *, sid: str, pool_k, pool_v,
                         prior_page_idx, delta_page_idx,
                         src_pos, seq_len: int, block_tokens: int,
                         tail_k=None, tail_v=None, producer: str = "",
                         round_idx: int = -1) -> "PagedSegmentCacheEntry":
        """Entry for a segment that prefix-extends a prior round's entry.

        Agent histories grow strictly by appending (round r's history =
        round r-1's history + the round's G output tokens), so the new
        entry's page table is the prior entry's pages — reused in place,
        possibly with a few copy-on-write replacements for blocks the
        round recomputed — followed by a fresh *delta allocation* that
        covers only the appended span. Restore work this round is the
        delta pages; the prefix pages cross the round boundary unread
        and unwritten.
        """
        prior = np.asarray(prior_page_idx, np.int32)
        delta = np.asarray(delta_page_idx, np.int32)
        page_idx = np.concatenate([prior, delta])
        nbh = -(-seq_len // block_tokens)
        assert page_idx.shape[0] == nbh, \
            (prior.shape, delta.shape, seq_len, block_tokens,
             "prefix + delta pages must tile the extended span exactly")
        return cls(sid=sid, pool_k=pool_k, pool_v=pool_v,
                   page_idx=page_idx, src_pos=src_pos, seq_len=seq_len,
                   block_tokens=block_tokens, tail_k=tail_k, tail_v=tail_v,
                   producer=producer, round_idx=round_idx)

    def materialize(self) -> SegmentCacheEntry:
        """Dense parity oracle: gather the pages (host-side) into the
        equivalent :class:`SegmentCacheEntry`. Tests and the dense
        fallback path use this; the serving fast path must not."""
        import torch

        from repro_torch.core.restore import gather_pages

        k, v = gather_pages(self.pool_k, self.pool_v, self.page_idx,
                            self.seq_len)
        if self.tail_k is not None:
            k = torch.cat([k, self.tail_k], dim=1)
            v = torch.cat([v, self.tail_v], dim=1)
        return SegmentCacheEntry(
            sid=self.sid, k=k, v=v, src_pos=self.src_pos,
            producer=self.producer, round_idx=self.round_idx)

    def nbytes(self) -> int:
        """Bytes attributable to THIS entry: its page table + dense tail.
        The pool itself is family-shared and accounted once by its owner
        (``PagedKVPool`` ledger key ``restore:family``)."""
        tail = (2 * self.tail_k.numel() * self.tail_k.element_size()
                if self.tail_k is not None else 0)
        return int(self.page_idx.nbytes) + tail


class SegmentIndex:
    """Segment-based hash table replacing fixed-size chunk hashing.

    Two requests containing the same shared update map it to the same cache
    object regardless of its absolute position in either prompt.
    """

    def __init__(self) -> None:
        self._entries: Dict[str, SegmentCacheEntry] = {}
        self.hits = 0
        self.misses = 0

    def put(self, entry: SegmentCacheEntry) -> None:
        self._entries[entry.sid] = entry

    def get(self, sid: str) -> Optional[SegmentCacheEntry]:
        e = self._entries.get(sid)
        if e is None:
            self.misses += 1
        else:
            self.hits += 1
        return e

    def __contains__(self, sid: str) -> bool:
        return sid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def nbytes(self) -> int:
        return sum(e.nbytes() for e in self._entries.values())

    def evict(self, sid: str) -> None:
        self._entries.pop(sid, None)

    def clear(self) -> None:
        self._entries.clear()
