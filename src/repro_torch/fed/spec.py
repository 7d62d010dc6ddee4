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
class Stream:
    """The streamed client axis: HOW MANY clients are resident on device.

    Only ``resident`` clients live on device at a time; the engine plans
    which clients each fixed-length ``window`` of rounds needs (by
    replaying the run's own draws on a clone of its generator —
    ``core.engine.replay_sids``) and, with ``prefetch=True``, builds the
    next window's rows on the host and copies them to the device on a
    side stream while the current window's rounds run. Fault-free
    streamed runs are bitwise the resident path on configs both support.

    ``resident`` must cover the distinct clients any single window can
    touch (at most ``n_chains * window``; the planner names the minimum
    viable value when it refuses)."""
    resident: int
    window: int = 1
    prefetch: bool = True

    def __post_init__(self):
        if self.resident < 1:
            raise ValueError(f"resident must be >= 1, got {self.resident}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


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
