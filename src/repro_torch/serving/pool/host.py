"""Host memory tier: where spilled (cold) device state lives.

The arrays themselves are converted in place by the manager (the owning
objects — ``MasterCache``, ``MirrorDiff``, segment entries — hold CPU
tensors while spilled and device tensors while resident; see
:class:`~repro_torch.serving.pool.manager.Spillable`), so the tier itself is
the *ledger* of what is off-device: per-owner page counts, byte sizes
and spill rounds, plus the capacity bound of the host buffer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class HostEntry:
    """One spilled owner's host-side record."""

    owner: str
    n_pages: int          # device pages the owner held (and will re-claim)
    nbytes: int           # actual bytes of the spilled arrays
    persistent: bool
    round_spilled: int


class HostTier:
    """Byte-bounded ledger of spilled owners.

    ``capacity_bytes=None`` means unbounded (the default: host DRAM is
    assumed plentiful relative to the device pool); ``0`` disables the
    tier entirely, which turns the manager into a pure evict-or-fail
    layer (useful as the no-offload baseline).
    """

    def __init__(self, capacity_bytes: Optional[int] = None):
        self.capacity_bytes = capacity_bytes
        self._entries: Dict[str, HostEntry] = {}
        self.peak_bytes = 0

    # --------------------------------------------------------------- api
    def fits(self, nbytes: int) -> bool:
        if self.capacity_bytes is None:
            return True
        return self.used_bytes() + nbytes <= self.capacity_bytes

    def put(self, entry: HostEntry) -> None:
        assert entry.owner not in self._entries, \
            f"{entry.owner} already spilled (page owned twice across tiers)"
        assert self.fits(entry.nbytes), \
            f"host tier over capacity for {entry.owner}"
        self._entries[entry.owner] = entry
        self.peak_bytes = max(self.peak_bytes, self.used_bytes())

    def pop(self, owner: str) -> Optional[HostEntry]:
        return self._entries.pop(owner, None)

    def get(self, owner: str) -> Optional[HostEntry]:
        return self._entries.get(owner)

    def __contains__(self, owner: str) -> bool:
        return owner in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def owners(self) -> List[str]:
        return list(self._entries)

    def used_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def used_pages(self) -> int:
        """Device pages the spilled owners will re-claim on reload."""
        return sum(e.n_pages for e in self._entries.values())
