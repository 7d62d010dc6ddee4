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
