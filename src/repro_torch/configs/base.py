"""Sampler settings (counterpart of ``repro.configs.base.SamplerConfig``).

``ArchConfig`` and the transformer presets come with the transformer
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Above this client count an implicit uniform ``probs()`` tuple is not
# materialized; ``probs()`` returns None and consumers treat None as
# uniform 1/S (``core.sampler.ShardScheme`` lowers both spellings to the
# same fp32 values).
_PROBS_TUPLE_LIMIT = 65536


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """FSGLD / DSGLD / SGLD settings (paper Secs. 2-3)."""

    method: str = "fsgld"  # 'sgld' | 'dsgld' | 'fsgld'
    step_size: float = 1e-4
    num_shards: int = 16
    shard_probs: Optional[Tuple[float, ...]] = None  # None -> uniform
    local_updates: int = 40  # T_local between reassignments (paper Sec 5.3)
    alpha: float = 1.0  # Remark 1 exploration knob; 0 recovers DSGLD
    surrogate: str = "diag"  # 'diag' | 'scalar'
    prior_precision: float = 1.0  # N(0, lambda^-1 I) prior on params
    temperature: float = 1.0  # noise scale; 0 -> MAP/SGD limit

    def probs(self) -> Optional[Tuple[float, ...]]:
        if self.shard_probs is not None:
            if len(self.shard_probs) != self.num_shards:
                raise ValueError(
                    f"{len(self.shard_probs)} shard_probs for "
                    f"{self.num_shards} shards")
            return tuple(self.shard_probs)
        if self.num_shards > _PROBS_TUPLE_LIMIT:
            return None
        return tuple(1.0 / self.num_shards for _ in range(self.num_shards))
