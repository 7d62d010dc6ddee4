"""The composed federation scenario spec (counterpart of
``repro.fed.spec``).

One :class:`Federation` names a scenario along three axes: WHERE the data
lives (:class:`PartitionSpec`, applied on the host, once), WHEN chains
communicate (:class:`CommSchedule`) and WHAT crosses the wire
(:class:`Compression`); the chain engine lowers the last two into its
rounds. The engine-identity spec lowers to nothing: a run under it is the
run without a federation, bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.fed.compress import Compression
from repro_torch.fed.partition import PartitionSpec
from repro_torch.fed.schedule import CommSchedule


@dataclasses.dataclass(frozen=True)
class Federation:
    """A complete federation scenario (hashable)."""
    partition: Optional[PartitionSpec] = None
    schedule: CommSchedule = CommSchedule()
    compression: Compression = Compression()

    @property
    def engine_identity(self) -> bool:
        """True iff the ENGINE-side pieces (schedule and compression)
        change nothing; the partition is host-side and never reaches the
        rounds."""
        return self.schedule.identity and self.compression.identity

    @property
    def identity(self) -> bool:
        return self.partition is None and self.engine_identity
