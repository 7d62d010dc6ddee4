"""Hierarchical cross-silo -> cross-device aggregation for the streamed
client axis (counterpart of ``repro.fed.hierarchy``; numpy only).

At ~10^6 clients server-side reductions cannot touch every client in one
flat pass: the streamed runtime (core/engine.py) only ever has the
resident window's clients on device. Aggregation therefore runs in two
tiers:

  * cross-DEVICE — inside a resident window, over the clients/chains that
    are actually on the device. For FA-LD server averaging this tier is
    the engine's masked average over the exchanging chains: it only ever
    reads the participating chains, so it composes with streaming
    unchanged (and stays bitwise identical to the resident path —
    tests/test_torch_stream.py).
  * cross-SILO — host-side, over per-silo partial aggregates. Client
    metadata reductions (the partition-aware ``shard_probs`` presets,
    client-count normalizations) run here in bounded-memory blocks so a
    10^6-client reduction never materializes more than one silo of
    intermediates at float64.

The helpers below implement the host tier. They are deliberately numpy:
the quantities they reduce (sizes, probabilities, per-silo sums) are
planner inputs, not traced values.
"""
from __future__ import annotations

import numpy as np

# Default clients per silo for the host-tier reductions. Any value gives
# the same result up to float64 associativity (tested against the flat
# reduction in tests/test_torch_stream.py); the default bounds the working set
# to ~0.5 MB per silo at 10^6 clients.
SILO = 65536


def silo_slices(n: int, silo: int = SILO):
    """Yield (start, stop) blocks covering [0, n) in silo-sized runs."""
    if silo < 1:
        raise ValueError(f"silo size must be >= 1, got {silo}")
    for start in range(0, n, silo):
        yield start, min(start + silo, n)


def hierarchical_sum(x, silo: int = SILO) -> float:
    """Two-tier sum: per-silo float64 partial sums, then a sum across the
    silo partials — the cross-silo leg of a streamed-axis reduction."""
    x = np.asarray(x)
    partials = [np.sum(x[a:b], dtype=np.float64)
                for a, b in silo_slices(x.shape[0], silo)]
    return float(np.sum(np.asarray(partials, np.float64)))


def hierarchical_mean(values, weights=None, silo: int = SILO) -> float:
    """Weighted mean via per-silo (sum w*v, sum w) partials.

    This is the server-averaging shape of the streamed axis: each silo
    contributes one (numerator, denominator) pair and the server combines
    pairs, never the raw per-client values.
    """
    v = np.asarray(values, np.float64)
    w = (np.ones_like(v) if weights is None
         else np.asarray(weights, np.float64))
    if v.shape[0] != w.shape[0]:
        raise ValueError(f"values/weights length mismatch: "
                         f"{v.shape[0]} != {w.shape[0]}")
    num = den = 0.0
    for a, b in silo_slices(v.shape[0], silo):
        num += float(np.sum(w[a:b] * v[a:b]))
        den += float(np.sum(w[a:b]))
    if den == 0.0:
        raise ValueError("hierarchical_mean: all weights are zero")
    return num / den


def normalize_hierarchical(x, silo: int = SILO) -> np.ndarray:
    """x / sum(x) with the denominator from ``hierarchical_sum`` — the
    normalization step of the partition-aware ``shard_probs`` presets.
    Returns float32 (the engine's f_s dtype); raises on a zero total."""
    x = np.asarray(x, np.float64)
    total = hierarchical_sum(x, silo)
    if total <= 0.0:
        raise ValueError(
            f"cannot normalize to probabilities: total is {total}")
    return (x / total).astype(np.float32)
