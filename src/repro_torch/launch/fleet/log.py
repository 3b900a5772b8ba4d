"""The append-only delta log: the fleet's single source of write truth.

All updates flow through one ``DeltaLog``. ``append`` stamps each
``DeltaBatch`` with a 1-based log sequence number (LSN) and the append IS
the commit point: an update is durable (fleet-visible) the moment it has
an LSN, before any replica has applied it. Replicas consume the log
independently — each keeps its own cursor and applies entries *at version
barriers* (when a draw stamped with a newer version arrives, or at drain),
so along the log

    snapshot.version == base_version + lsn

holds on every replica, and each replica's snapshot sequence is
bit-identical to ``Database.apply``-ing the log entries in order on a
single engine (tested in tests/test_torch_fleet.py).
"""
from __future__ import annotations

from typing import List

from repro_torch.core.delta import DeltaBatch

__all__ = ["DeltaLog"]


class DeltaLog:
    """Append-only, in-process. ``base_version`` is the version of the
    snapshot the log starts from (entry ``lsn`` advances it to
    ``base_version + lsn``)."""

    def __init__(self, base_version: int = 0):
        self.base_version = base_version
        self._entries: List[DeltaBatch] = []

    def append(self, delta: DeltaBatch) -> int:
        """Commit ``delta``; returns its LSN (1-based)."""
        lsn = len(self._entries) + 1
        self._entries.append(delta.with_lsn(lsn))
        return lsn

    @property
    def head(self) -> int:
        """The highest committed LSN (0 when empty)."""
        return len(self._entries)

    @property
    def head_version(self) -> int:
        """The snapshot version a fully caught-up replica sits at."""
        return self.base_version + self.head

    def entry(self, lsn: int) -> DeltaBatch:
        if not 1 <= lsn <= self.head:
            raise IndexError(f"lsn {lsn} outside [1, {self.head}]")
        return self._entries[lsn - 1]

    def read(self, after_lsn: int, upto_lsn: int) -> List[DeltaBatch]:
        """Entries with ``after_lsn < lsn <= upto_lsn`` in order — what a
        replica at ``after_lsn`` replays to reach ``upto_lsn``."""
        if upto_lsn > self.head:
            raise IndexError(f"read past the head: {upto_lsn} > {self.head}")
        return self._entries[after_lsn:upto_lsn]

    def version_to_lsn(self, version: int) -> int:
        return version - self.base_version

    def __len__(self) -> int:
        return self.head
