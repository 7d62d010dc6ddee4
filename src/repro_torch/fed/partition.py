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
import difflib
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.fed.hierarchy import normalize_hierarchical


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


# ---------------------------------------------------------------------------
# partition-aware shard_probs presets (paper Eq. 4's f_s selection probs)
# ---------------------------------------------------------------------------

SHARD_PROB_PRESETS = {
    # f_s = 1/S — the paper's default; identical values to probs=None.
    "uniform": lambda sizes: np.full(
        (len(sizes),), 1.0 / len(sizes), np.float32),
    # f_s = N_s / N — visits proportional to data held, so the DSGLD
    # unbiasing factor N_s/(f_s m) = N/m is the SAME for every client
    # (the variance-minimizing choice under quantity skew).
    "size-proportional": lambda sizes: normalize_hierarchical(
        np.asarray(sizes, np.float64)),
    # f_s ∝ sqrt(N_s) — the compromise between uniform exploration and
    # size-proportional visit rates for heavy-tailed client sizes.
    "sqrt-size": lambda sizes: normalize_hierarchical(
        np.sqrt(np.asarray(sizes, np.float64))),
}


def shard_prob_preset_names():
    return sorted(SHARD_PROB_PRESETS)


def resolve_shard_probs(name_or_probs, sizes) -> np.ndarray:
    """Resolve a ``shard_probs`` preset name (or pass explicit probs
    through) to an (S,) float32 array normalized against the TRUE client
    sizes. Unknown names get the registry error contract: a KeyError with
    a did-you-mean hint and the available names."""
    if not isinstance(name_or_probs, str):
        return np.asarray(name_or_probs, np.float32)
    try:
        fn = SHARD_PROB_PRESETS[name_or_probs]
    except KeyError:
        near = difflib.get_close_matches(str(name_or_probs),
                                         shard_prob_preset_names(), n=1)
        hint = f" (did you mean {near[0]!r}?)" if near else ""
        raise KeyError(
            f"unknown shard_probs preset {name_or_probs!r}{hint}; "
            f"available: {', '.join(shard_prob_preset_names())}") from None
    return fn(np.asarray(sizes))


# ---------------------------------------------------------------------------
# lazy client sources: the streamed-axis data contract
# ---------------------------------------------------------------------------
#
# A *client source* replaces the materialize-all (S, max_n, ...) stacked
# pytree when S is too large to hold: it answers ``rows(ids)`` for the
# resident subset only. Duck-typed: anything exposing
#
#     num_clients : int
#     sizes       : (S,) numpy int array — true per-client row counts
#     max_size    : int — the padded per-client row count
#     rows(ids)   : (K,) int array -> pytree of (K, max_size, ...) host
#                   arrays or tensors
#
# is a client source. ``rows`` must be a pure function of ``ids``: the
# streamed runtime calls it once per resident window and the resident
# path once with arange(S), and that determinism is what makes streamed
# == resident bitwise.


def is_client_source(obj) -> bool:
    return (hasattr(obj, "rows") and hasattr(obj, "num_clients")
            and hasattr(obj, "sizes") and hasattr(obj, "max_size"))


class SyntheticClientSource:
    """Synthetic non-IID token data for up to ~10^6 clients, generated per
    client on demand, on the host.

    Client c's rows are a pure function of (seed, c): a numpy
    ``Generator`` seeded from ``SeedSequence([seed, c])`` draws the
    client's own Dirichlet(alpha) unigram over the vocabulary (as
    gammas), then its ``tokens`` / ``labels``, each (shard_size,
    seq_len) int32 (labels are the tokens shifted by one). Any resident
    subset is generated without touching the other clients (contrast
    ``data.token_shards``, which draws every client jointly). The bits
    are not the reference's (its ``fold_in`` keys); the structure is."""

    def __init__(self, seed: int, *, num_clients: int, shard_size: int,
                 seq_len: int, vocab_size: int, alpha: float = 0.1):
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        self.seed = int(seed)
        self.num_clients = int(num_clients)
        self.shard_size = int(shard_size)
        self.seq_len = int(seq_len)
        self.vocab_size = int(vocab_size)
        self.alpha = float(alpha)
        self.sizes = np.full((self.num_clients,), self.shard_size,
                             np.int64)
        self.max_size = self.shard_size

    def _one(self, cid: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed,
                                                            cid]))
        g = rng.gamma(self.alpha, size=self.vocab_size)
        p = g / g.sum()
        return rng.choice(self.vocab_size, size=(self.shard_size,
                                                 self.seq_len + 1), p=p)

    def rows(self, ids) -> dict:
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_clients):
            raise IndexError(f"client ids outside [0, {self.num_clients})")
        t = np.stack([self._one(int(c)) for c in ids]) if ids.size else \
            np.zeros((0, self.shard_size, self.seq_len + 1), np.int64)
        return {"tokens": t[..., :-1].astype(np.int32),
                "labels": t[..., 1:].astype(np.int32)}


class PartitionedSource:
    """Lazy per-client shard construction over pooled data: the
    ``partition()`` split without the materialize-all stacking.

    The client -> row index lists are computed once (O(N) host work,
    the same draws ``partition`` makes); ``rows(ids)`` gathers and pads
    only the requested clients with ``pad_shards``'s fill (NaN floats,
    int-min integers), so ``rows(arange(S))`` is ``partition()``'s
    stacked output."""

    def __init__(self, data, spec: PartitionSpec,
                 rng: Optional[np.random.Generator] = None):
        if rng is None:
            rng = np.random.default_rng(spec.seed)
        self.data = tu.tree_map(lambda a: torch.as_tensor(_np(a)), data)
        self.spec = spec
        self._assign = [torch.from_numpy(np.sort(np.asarray(a, np.int64)))
                        for a in _KINDS[spec.kind](rng, data, spec)]
        self.num_clients = spec.num_shards
        self.sizes = np.asarray([len(a) for a in self._assign], np.int64)
        self.max_size = int(self.sizes.max())

    def rows(self, ids):
        ids = np.asarray(ids, np.int64)

        def pad_one(leaf):
            value = (float("nan") if leaf.dtype.is_floating_point
                     else torch.iinfo(leaf.dtype).min)
            out = torch.full((len(ids), self.max_size)
                             + tuple(leaf.shape[1:]), value,
                             dtype=leaf.dtype)
            for j, cid in enumerate(ids):
                idx = self._assign[int(cid)]
                out[j, :len(idx)] = leaf[idx]
            return out

        return tu.tree_map(pad_one, self.data)
