"""Declarative non-IID partitioners: pooled data -> padded client shards
(counterpart of ``repro.fed.partition``).

The splitters take POOLED data (a pytree of (N, ...) tensors or arrays)
and produce the engine's shard format: stacked (S, max_n, ...) leaves
padded to the longest client by ``core.engine.pad_shards`` (NaN pad rows,
never sampled) plus the true per-client ``sizes``:

  * 'iid'       — uniform random equal split (the control);
  * 'dirichlet' — Dirichlet(alpha) LABEL skew: each class's examples are
    divided among clients by a per-class Dirichlet draw;
  * 'quantity'  — Dirichlet(alpha) QUANTITY skew: clients hold the same
    distribution in very different amounts (ragged shards);
  * 'covariate' — examples sorted along the features' principal direction
    and split contiguously.

Partitioning runs on the host, once, before sampling, from an explicit
``numpy.random.Generator`` (by default seeded with the spec's ``seed``,
so changing the scenario never perturbs the sampling stream). The split
differs from the JAX package's (another generator); the structure is the
same.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tu


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """How pooled data is split onto clients."""
    kind: str = "iid"
    num_shards: int = 10
    alpha: float = 0.5          # Dirichlet concentration (dirichlet/quantity)
    label_key: str = "y"        # dirichlet: which field carries the labels
    feature_key: str = "x"      # covariate: which field carries the inputs
    min_size: int = 2           # every client keeps at least this many rows
    seed: int = 0               # partition RNG (independent of sampling)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown partition kind {self.kind!r}; pick "
                             f"from {tuple(_KINDS)}")
        if self.num_shards < 1 or self.min_size < 1:
            raise ValueError("num_shards and min_size must be >= 1")


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _pooled_n(data) -> int:
    return int(tu.leaves(data)[0].shape[0])


def _rebalance(assign: list, min_size: int) -> list:
    """Move rows from the largest clients until every client holds at
    least ``min_size`` (a tiny Dirichlet draw can empty a client, and an
    empty shard would break the N_s / (f_s m) unbiasing)."""
    assign = [list(a) for a in assign]
    while True:
        small = min(range(len(assign)), key=lambda s: len(assign[s]))
        if len(assign[small]) >= min_size:
            return [np.asarray(a, np.int64) for a in assign]
        big = max(range(len(assign)), key=lambda s: len(assign[s]))
        if len(assign[big]) <= min_size:
            raise ValueError("not enough rows to give every client "
                             f"{min_size}")
        assign[small].append(assign[big].pop())


def iid_partition(rng: np.random.Generator, data, spec: PartitionSpec):
    """Uniform random equal split (drops the < S remainder)."""
    N, S = _pooled_n(data), spec.num_shards
    per = N // S
    if per < spec.min_size:
        raise ValueError(f"{N} rows cannot give {S} clients "
                         f"{spec.min_size} each")
    perm = rng.permutation(N)
    return [perm[s * per:(s + 1) * per] for s in range(S)]


def dirichlet_label_skew(rng: np.random.Generator, data,
                         spec: PartitionSpec):
    """Per-class Dirichlet(alpha) proportions over clients; each class's
    shuffled examples are split by those proportions."""
    S = spec.num_shards
    labels = _np(data[spec.label_key]).reshape(-1)
    classes = np.unique(labels)
    g = rng.gamma(spec.alpha, size=(len(classes), S)) + 1e-12
    props = g / g.sum(1, keepdims=True)
    assign = [[] for _ in range(S)]
    for ci, c in enumerate(classes):
        idx = np.flatnonzero(labels == c)
        idx = idx[rng.permutation(len(idx))]
        cuts = (np.cumsum(props[ci])[:-1] * len(idx)).astype(np.int64)
        for s, part in enumerate(np.split(idx, cuts)):
            assign[s].extend(part.tolist())
    return _rebalance(assign, spec.min_size)


def quantity_skew(rng: np.random.Generator, data, spec: PartitionSpec):
    """The same distribution everywhere, Dirichlet(alpha)-skewed AMOUNTS."""
    N, S = _pooled_n(data), spec.num_shards
    if N < S * spec.min_size:
        raise ValueError(f"{N} rows cannot give {S} clients "
                         f"{spec.min_size} each")
    g = rng.gamma(spec.alpha, size=S) + 1e-12
    sizes = np.maximum((g / g.sum() * N).astype(np.int64), spec.min_size)
    # trim the largest clients still above the floor until the sizes fit
    while sizes.sum() > N:
        sizes[int(np.argmax(np.where(sizes > spec.min_size, sizes, -1)))] \
            -= 1
    perm = rng.permutation(N)
    return list(np.split(perm[:int(sizes.sum())], np.cumsum(sizes)[:-1]))


def covariate_shift(rng: np.random.Generator, data, spec: PartitionSpec):
    """Sort by the principal direction of the features and split
    contiguously: client s sees the s-th slice of input space."""
    N, S = _pooled_n(data), spec.num_shards
    x = _np(data[spec.feature_key]).astype(np.float64).reshape(N, -1)
    xc = x - x.mean(0)
    v = rng.standard_normal(xc.shape[1])
    for _ in range(8):  # power iteration: enough for a split direction
        v = xc.T @ (xc @ v)
        v /= np.linalg.norm(v) + 1e-30
    order = np.argsort(xc @ v, kind="stable")
    per = N // S
    if per < spec.min_size:
        raise ValueError(f"{N} rows cannot give {S} clients "
                         f"{spec.min_size} each")
    return [order[s * per:(s + 1) * per] for s in range(S)]


_KINDS = {
    "iid": iid_partition,
    "dirichlet": dirichlet_label_skew,
    "quantity": quantity_skew,
    "covariate": covariate_shift,
}


def partition(rng: Optional[np.random.Generator], data,
              spec: PartitionSpec, device=None):
    """Pooled pytree -> (padded shard_data on ``device``, sizes). ``rng``
    None: ``numpy.random.default_rng(spec.seed)``."""
    from repro_torch.core.engine import pad_shards
    if rng is None:
        rng = np.random.default_rng(spec.seed)
    pooled = tu.tree_map(lambda a: torch.as_tensor(_np(a)), data)
    shards = []
    for idx in _KINDS[spec.kind](rng, data, spec):
        rows = torch.from_numpy(np.sort(np.asarray(idx, np.int64)))
        shards.append(tu.tree_map(lambda a: a[rows].to(device), pooled))
    return pad_shards(shards)
