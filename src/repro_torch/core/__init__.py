"""The paper's contribution in PyTorch: round-aware segments, collective KV
cache reuse, diff-aware Master-Mirror storage and the page-sharing family
restore."""
from repro_torch.core.collector import (CollectiveResult, KVCollector,
                                        PagedPrivate, ReusePlan,
                                        group_compatible)
from repro_torch.core.diff_store import (BLOCK_TOKENS, MasterCache,
                                         MirrorDiff, MirrorHandle,
                                         build_round_family,
                                         compression_stats, pack_family,
                                         trim_family)
from repro_torch.core.pic import (PagedHistory, PICResult, align_cached_keys,
                                  n_sel_for_blocks, pic_prefill)
from repro_torch.core.restore import (family_pool_pages,
                                      fused_restore_family_shared,
                                      gather_pages)
from repro_torch.core.rounds import (AgentState, AllGather, AllGatherTrace,
                                     GatherTopology, Round, SubsetGather,
                                     generate_trace, round_prompt)
from repro_torch.core.segments import (PRIVATE, SHARED, TASK,
                                       PagedSegmentCacheEntry, PromptLayout,
                                       Segment, SegmentCacheEntry,
                                       SegmentIndex, Span, build_prompt,
                                       segment_hash)

__all__ = [
    "BLOCK_TOKENS", "PRIVATE", "SHARED", "TASK", "AgentState", "AllGather",
    "AllGatherTrace", "CollectiveResult", "GatherTopology", "KVCollector",
    "MasterCache", "MirrorDiff", "MirrorHandle", "PICResult", "PagedHistory",
    "PagedPrivate", "PagedSegmentCacheEntry", "PromptLayout", "ReusePlan",
    "Round", "Segment", "SegmentCacheEntry", "SegmentIndex", "Span",
    "SubsetGather", "align_cached_keys", "build_prompt", "build_round_family",
    "compression_stats", "family_pool_pages", "fused_restore_family_shared",
    "gather_pages", "generate_trace", "group_compatible", "n_sel_for_blocks",
    "pack_family", "pic_prefill", "round_prompt", "segment_hash",
    "trim_family",
]
