"""Communication schedules: WHEN chains exchange state with the server
(counterpart of ``repro.fed.schedule``).

  * ``delay``          — chains communicate (are reassigned, and exchange
    payloads) only every ``delay``-th round; in between they stay on their
    client, so ``delay=k`` with ``local_steps=T`` is k*T local updates per
    communication (the x-axis of the paper's Figs. 2-3);
  * ``participation``  — at each communication round every chain takes
    part independently with this probability; the others keep their
    client and skip the exchange. Round 0 always has full participation,
    so every chain gets an initial assignment;
  * ``straggler_prob`` — per round, each chain's update is DROPPED with
    this probability: its state does not advance and its trace repeats the
    pre-round position.

The masks take uniforms in [0, 1), not a key: the engine draws them from
its ``torch.Generator`` (``core.engine.draw_round``), so a test can hand
in the very uniforms a JAX key gives (``bernoulli(key, p, shape)`` is
``uniform(key, shape) < p``). Whether round ``r`` communicates is a
Python bool of ``r``: no device sync per round.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """Declarative communication cadence for the chain engine."""
    delay: int = 1
    participation: float = 1.0
    straggler_prob: float = 0.0

    def __post_init__(self):
        if self.delay < 1:
            raise ValueError(f"delay must be >= 1, got {self.delay}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1], got "
                             f"{self.participation}")
        if not 0.0 <= self.straggler_prob < 1.0:
            raise ValueError("straggler_prob must be in [0, 1), got "
                             f"{self.straggler_prob}")

    @property
    def identity(self) -> bool:
        """True iff the schedule changes nothing about a round."""
        return (self.delay == 1 and self.participation >= 1.0
                and self.straggler_prob <= 0.0)


def comm_mask(sched: CommSchedule, r: int) -> bool:
    """Does round ``r`` communicate? Round 0 always does."""
    return r % sched.delay == 0


def participation_mask(sched: CommSchedule, u: torch.Tensor,
                       r: int) -> torch.Tensor:
    """(C,) bool participation of one round from (C,) uniforms ``u``;
    all True at round 0."""
    if sched.participation >= 1.0:
        return torch.ones(u.shape, dtype=torch.bool, device=u.device)
    return (u < sched.participation) | (r == 0)


def straggler_mask(sched: CommSchedule, u: torch.Tensor) -> torch.Tensor:
    """(C,) bool from (C,) uniforms: True where the round's update is
    dropped."""
    return u < sched.straggler_prob


# ---------------------------------------------------------------------------
# Resident-set planning for the streamed client axis.
#
# The streamed runtime (core/engine.py) keeps only a K-client resident
# window on device and prefetches the next window while the current one
# runs. Which clients a window needs is fixed by the run's generator:
# ``replay_sids`` draws every round on a CLONE of it, through the
# engine's own ``draw_round``, so the plan cannot drift from the rounds.
# ``plan_stream`` then slices the assignment into fixed-length windows
# and emits one sorted, tail-padded resident id set per window.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamWindow:
    """One prefetch unit of a streamed run.

    ``resident_ids`` is (resident,) int32, sorted ascending, tail-padded by
    repeating the largest id so every window has the same shape. Padding
    with a repeated real id keeps the global -> resident-local rank
    (the number of ``resident_ids`` below a client id) exact for every
    real id.
    """
    r0: int
    length: int
    resident_ids: np.ndarray

    def __post_init__(self):
        if self.length < 1:
            raise ValueError(f"window length must be >= 1, got "
                             f"{self.length}")
        ids = np.asarray(self.resident_ids)
        if ids.ndim != 1 or ids.dtype != np.int32:
            raise ValueError(f"resident_ids must be 1-D int32, got "
                             f"{ids.shape} {ids.dtype}")


def replay_sids(generator, engine, *, num_rounds: int, n_chains: int,
                reassign: str = "permutation", federation=None,
                dim: int = 0, num_leaves: int = 1,
                noise_like=None) -> np.ndarray:
    """(num_rounds, n_chains) int32 — the client each chain HOLDS at every
    round of ``engine``'s run from ``generator`` (left untouched: the
    replay draws on a clone). See ``core.engine.replay_sids``."""
    from repro_torch.core.engine import replay_sids as replay
    return replay(generator, engine, num_rounds=num_rounds,
                  n_chains=n_chains, reassign=reassign,
                  federation=federation, dim=dim, num_leaves=num_leaves,
                  noise_like=noise_like)


def plan_stream(sids: np.ndarray, *, resident: int,
                window: int = 1) -> list:
    """Slice a replayed (R, n_chains) assignment into ``StreamWindow``s.

    Raises an actionable error naming the minimum viable ``resident`` when
    any window needs more distinct clients than fit on device.
    """
    sids = np.asarray(sids)
    if sids.ndim != 2 or sids.shape[0] < 1:
        raise ValueError(f"sids must be (rounds >= 1, chains), got "
                         f"{sids.shape}")
    if window < 1:
        raise ValueError(f"stream window must be >= 1, got {window}")
    num_rounds = sids.shape[0]
    blocks = [(r0, sids[r0:r0 + window]) for r0 in range(0, num_rounds,
                                                         window)]
    need = max(np.unique(blk).size for _, blk in blocks)
    if need > resident:
        raise ValueError(
            f"stream plan needs up to {need} distinct resident clients per "
            f"{window}-round window but Stream(resident={resident}); raise "
            f"resident to at least {need}, or shrink the window / chain "
            f"count")
    out = []
    for r0, blk in blocks:
        ids = np.unique(blk).astype(np.int32)  # sorted ascending
        pad = np.full((resident - ids.size,), ids[-1], np.int32)
        out.append(StreamWindow(r0=r0, length=int(blk.shape[0]),
                                resident_ids=np.concatenate([ids, pad])))
    return out
