"""Chain health: divergence detection + recovery policies (counterpart of
``repro.core.health``; numpy only).

A single NaN in one chain's update silently poisons its whole trace, and
downstream ``ess``/``rhat`` with it. This module makes chain health a
declarative part of the run:

  * :class:`Recovery` — the policy the engine applies once per ROUND in
    its host loop (``core/engine.py``): a finite-state check on theta
    (and momentum, for SGHMC) plus an optional log-posterior-explosion
    detector, per chain, with no extra kernel launches.

      - ``policy='quarantine'`` freezes a diverged chain at its last
        healthy state: its trace repeats the frozen position from the
        faulty round on, its updates are computed and discarded (the
        straggler machinery's masking), and it never contaminates any
        other chain — every other chain's trace is bitwise that of a
        fault-free run.
      - ``policy='respawn'`` re-seeds the diverged chain from the first
        healthy chain's state (deterministic given the generator) and
        lets it keep sampling; the health word counts the respawns.

  * :class:`RunHealth` — the per-chain report the run returns: the raw
    health word plus the derived ``healthy`` mask that
    ``core/diagnostics.py`` takes to exclude quarantined chains from
    ess/rhat.

The finite check is an ``isfinite`` reduction over each chain's own
state; the log-posterior probe (``divergence_threshold``) is ONE extra
likelihood evaluation per chain per ROUND on a minibatch drawn from a
generator of its own, seeded from the run generator's state — it
consumes nothing of the sampling stream, so a fault-free run with health
tracking on is bitwise identical to one with it off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

POLICIES = ("quarantine", "respawn")

# salt of the health-probe generator's seed (hashed with the run
# generator's state and the round, ``core.engine.probe_generator``): the
# probe stream is parallel to (never consumed from) the sampling stream.
HEALTH_PROBE_SALT = 0x48EA17


@dataclasses.dataclass(frozen=True)
class Recovery:
    """Declarative fault-recovery policy for the chain engine.

    policy:
      'quarantine' — a diverged chain is frozen at its last healthy
                     state for the rest of the run (masked out of its
                     trace's advancement; surfaced as unhealthy in
                     :class:`RunHealth` so diagnostics exclude it).
      'respawn'    — a diverged chain is re-seeded from the first
                     healthy chain of the run and keeps sampling
                     (deterministic given the generator); if every
                     chain diverged at once it freezes instead.

    divergence_threshold: when set, a chain also counts as diverged
      once its probed unnormalized log-posterior drops more than this
      many nats below its reference level (the log-posterior-explosion
      detector); None = finite-state checks only. The reference is a
      quantile over the chain's last ``window`` probes, NOT a running
      max: a max reference is inflated by the single luckiest probe of
      the whole run (minibatch log-posterior noise), which forces the
      threshold to be set far above the noise spread and lets a slowly
      diverging chain fall a long way before tripping. The windowed
      quantile tracks the chain's recent healthy plateau, so a tight
      threshold (a few times the probe IQR) trips a slow divergence as
      soon as it drops below the recent level.
    window: how many recent probes the reference quantile is taken
      over. The window starts empty (-inf padded); a chain only trips
      once enough probes accumulated for the quantile to be finite, so
      warm-up rounds never false-trip.
    quantile: the reference quantile in [0, 1] (nearest-rank over the
      window; 0.5 = median).
    check_momentum: include SGHMC momenta in the finite-state check
      (ignored for Langevin dynamics).

    Hashable, like the JAX package's.
    """
    policy: str = "quarantine"
    divergence_threshold: Optional[float] = None
    check_momentum: bool = True
    window: int = 8
    quantile: float = 0.5

    def __post_init__(self):
        assert self.policy in POLICIES, self.policy
        if self.divergence_threshold is not None:
            assert self.divergence_threshold > 0, self.divergence_threshold
        assert self.window >= 1, self.window
        assert 0.0 <= self.quantile <= 1.0, self.quantile

    @property
    def use_detector(self) -> bool:
        return self.divergence_threshold is not None


@dataclasses.dataclass
class RunHealth:
    """Per-chain health report of one engine run.

    ``word`` is an (n_chains,) int32 whose meaning depends on the
    policy: under 'quarantine', 0 = healthy and k > 0 = quarantined
    after round k-1 (the first faulty round, 1-based so 0 stays the
    healthy sentinel); under 'respawn' it counts how many times the
    chain was respawned (every chain is live at the end either way).
    ``lp_ref`` is the final windowed-quantile log-posterior reference
    per chain when the divergence detector ran (-inf while a chain's
    probe window is still warming up), else None.
    """
    word: np.ndarray
    policy: str = "quarantine"
    lp_ref: Optional[np.ndarray] = None

    @property
    def healthy(self) -> np.ndarray:
        """(n_chains,) bool — chains whose traces are trustworthy end to
        end: never quarantined (and, under respawn, never respawned —
        a respawned chain's early trace belongs to its donor's basin)."""
        return np.asarray(self.word) == 0

    @property
    def n_healthy(self) -> int:
        return int(self.healthy.sum())

    @property
    def n_chains(self) -> int:
        return int(np.asarray(self.word).shape[0])

    def __repr__(self):
        return (f"RunHealth(policy={self.policy!r}, "
                f"healthy={self.n_healthy}/{self.n_chains})")
