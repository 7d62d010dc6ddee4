"""Per-round sampler telemetry: the ``Telemetry`` spec + ``MetricsFrame``
(counterpart of ``repro.obs.telemetry``; numpy only).

The paper's claims are about dynamics over ROUNDS — conducive gradients
shrinking the estimator correction, delayed chains staying near the
posterior — so the metrics live where the rounds live: the engine's round
loop (core/engine.py) computes one fp32 row per metric per round per
chain, on the device, and brings the rows to the host once every
``log_every`` rounds. Everything is computed from values the round
already holds (post-round state, exchange masks, health words) plus one
optional PROBE evaluation per round whose minibatch comes from a
generator of its own, seeded from the run generator's state and
``TELEMETRY_PROBE_SALT`` (``core.engine.probe_generator``) — the same
stream isolation as the health detector's ``HEALTH_PROBE_SALT``, so
telemetry-on runs are bitwise identical to telemetry-off runs.

Metric rows (all (rounds, chains) fp32 in the frame):

  theta_norm      ||theta|| at the round end.
  drift_norm      ||theta_end - theta_start|| over the round's T local
                  steps (per-round movement; collapses when a chain is
                  frozen by a straggler/quarantine mask).
  noise_scale     the nominal injected-noise std of one local step:
                  sqrt(h * tau) for Langevin (FA-LD's amplified
                  per-client tau included), sqrt(2 * friction * tau * h)
                  for SGHMC.
  conducive_norm  ||g_s(theta)|| — the paper's Eq. 5 correction at the
                  round-end state against the live surrogate bank
                  (zero when the method carries no surrogate).
  participation   1.0 when the chain exchanged with the server this
                  round (comm schedule AND participation draw AND not
                  quarantined), else 0.0; always 1.0 on the
                  identity/oracle path (every round reassigns).
  bytes_per_round participation * the wire-byte estimate of one
                  exchange, both legs (``Compression.bytes_per_round``;
                  8 bytes/coordinate for exact exchange).
  health_word     the recovery health word after this round's check
                  (0.0 = healthy; zeros when no Recovery policy).
  grad_norm       [probe] ||grad log_lik(theta, probe minibatch)|| at
                  the round-end state.
  log_post        [probe] log_lik(theta, probe minibatch)
                  - 0.5 * prior_precision * ||theta||^2 — the same
                  statistic the health detector probes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Probe salt: telemetry probes draw their minibatches from a generator
# seeded with this salt, never from the sampling stream — distinct from
# core.health.HEALTH_PROBE_SALT so the two probes are independent too.
TELEMETRY_PROBE_SALT = 0x0B5E7B

_BASE_NAMES = ("theta_norm", "drift_norm", "noise_scale",
               "conducive_norm", "participation", "bytes_per_round",
               "health_word")
_PROBE_NAMES = ("grad_norm", "log_post")


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """What the round loop measures (``Execution.telemetry``).

    ``probe=True`` adds the probe-batch metrics (grad_norm, log_post) —
    one extra likelihood value_and_grad per chain per ROUND, ~1/T of the
    round's gradient work. ``probe=False`` keeps only the closed-form
    metrics (no extra likelihood evaluations at all).

    ``log_every`` splits the run into that many-round segments: after
    each the rows come to the host (one device sync per segment, none
    per round) and an ``engine.progress`` trace event is emitted (round
    counter, steps/s, per-metric means) — the periodic progress
    reporting ``launch/train.py --log-every`` surfaces. A segment
    boundary changes nothing of the run, so a segmented run is bitwise
    a one-shot run.
    """
    probe: bool = True
    log_every: Optional[int] = None

    def __post_init__(self):
        if self.log_every is not None and self.log_every < 1:
            raise ValueError(
                f"Telemetry.log_every must be >= 1, got {self.log_every}")

    @property
    def names(self) -> tuple:
        """Metric-row names in frame order — sorted, as the reference's
        frames are."""
        return tuple(sorted(
            _BASE_NAMES + (_PROBE_NAMES if self.probe else ())))


@dataclasses.dataclass
class MetricsFrame:
    """Round-major telemetry: ``metrics[name]`` is a (rounds, chains)
    fp32 array. The exporters (``repro_torch.obs.exporters``) serialize it to
    JSONL (one record per round) and Prometheus textfile format."""
    metrics: dict

    @property
    def names(self) -> tuple:
        return tuple(self.metrics)

    @property
    def rounds(self) -> int:
        return int(next(iter(self.metrics.values())).shape[0])

    @property
    def n_chains(self) -> int:
        return int(next(iter(self.metrics.values())).shape[1])

    def __post_init__(self):
        assert self.metrics, "empty MetricsFrame"
        shape = next(iter(self.metrics.values())).shape
        for name, arr in self.metrics.items():
            assert arr.ndim == 2 and arr.shape == shape, (name, arr.shape)

    def summary(self) -> dict:
        """Per-metric mean over all rounds and chains (floats)."""
        return {n: float(np.mean(a)) for n, a in self.metrics.items()}

    def last_round(self) -> dict:
        """Per-metric (chains,) row of the final round."""
        return {n: np.asarray(a[-1]) for n, a in self.metrics.items()}

    @classmethod
    def concat(cls, frames: list) -> "MetricsFrame":
        """Stitch per-segment frames along the round axis."""
        assert frames, "nothing to concat"
        names = frames[0].names
        assert all(f.names == names for f in frames), \
            [f.names for f in frames]
        return cls({n: np.concatenate([f.metrics[n] for f in frames])
                    for n in names})
