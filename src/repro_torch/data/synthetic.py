"""Synthetic federated non-IID data generators (counterpart of
``repro.data.synthetic``), driven by an explicit ``torch.Generator`` and
built on the generator's device:

  * gaussian_shards — Sec 5.1: S shards from N(mu_s, I), mu_s ~ U[-s, s]^d
  * susy_shards     — Sec 5.3: binary classification, per-shard label
                      proportions pi_s ~ Beta(a, a) (a=100 IID, 0.5 non-IID)
  * susy_test_set   — a balanced held-out set from the same classes
  * token_shards    — federated non-IID token streams: each client's own
                      Dirichlet(alpha)-skewed unigram

The numbers differ from the JAX package's (another generator); the
structure is the same.
"""
from __future__ import annotations

import math

import torch


def gaussian_shards(generator: torch.Generator, *, num_shards=10,
                    shard_size=200, dim=2, spread=6.0):
    dev = generator.device
    mus = (torch.rand((num_shards, dim), generator=generator, device=dev)
           * 2 - 1) * spread
    x = mus[:, None, :] + torch.randn((num_shards, shard_size, dim),
                                      generator=generator, device=dev)
    return {"x": x}, mus


def _gamma(generator: torch.Generator, a: float, n: int) -> torch.Tensor:
    """n draws of Gamma(a, 1) in float64 (Marsaglia-Tsang; a < 1 boosted
    through Gamma(a + 1) * U^(1/a))."""
    dev = generator.device
    d = (a + 1.0 if a < 1.0 else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(n, dtype=torch.float64, device=dev)
    todo = torch.ones(n, dtype=torch.bool, device=dev)
    while bool(todo.any()):
        x = torch.randn(n, generator=generator, device=dev,
                        dtype=torch.float64)
        u = torch.rand(n, generator=generator, device=dev,
                       dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    if a < 1.0:
        u = torch.rand(n, generator=generator, device=dev,
                       dtype=torch.float64)
        out = out * u ** (1.0 / a)
    return out


def _beta(generator: torch.Generator, a: float, b: float,
          n: int) -> torch.Tensor:
    x, y = _gamma(generator, a, n), _gamma(generator, b, n)
    return (x / (x + y)).to(torch.float32)


def susy_shards(generator: torch.Generator, *, num_shards=30,
                shard_size=9_000, dim=18, beta_a=0.5, sep=1.2):
    """Label-imbalanced binary classification shards. The class-
    conditional distributions are fixed Gaussians with mean separation
    ``sep``; shard s draws labels Bernoulli(pi_s), pi_s ~ Beta(a, a)."""
    dev = generator.device
    mu_pos = torch.randn(dim, generator=generator, device=dev) * 0.3 \
        + sep / 2
    mu_neg = -mu_pos
    pi = _beta(generator, beta_a, beta_a, num_shards)
    y = (torch.rand((num_shards, shard_size), generator=generator,
                    device=dev) < pi[:, None]).to(torch.float32)
    noise = torch.randn((num_shards, shard_size, dim), generator=generator,
                        device=dev)
    x = torch.where(y[..., None] > 0.5, mu_pos, mu_neg) + noise
    return {"x": x, "y": y}, pi


def token_shards(generator: torch.Generator, *, num_shards: int,
                 shard_size: int, seq_len: int, vocab_size: int,
                 alpha: float = 0.1) -> dict:
    """Client s samples its ``shard_size`` sequences of ``seq_len + 1``
    tokens i.i.d. from its own unigram p_s ~ Dirichlet(alpha) over the
    vocabulary, drawn as normalised Gamma(alpha) variates in float64 (a
    low alpha makes the clients highly heterogeneous). Returns
    {'tokens', 'labels'}, (S, shard_size, seq_len) int64: labels are the
    tokens shifted by one. Draws from ``generator``: the Gammas of all
    clients, then each client's tokens in client order."""
    dev = generator.device
    g = _gamma(generator, alpha, num_shards * vocab_size).reshape(
        num_shards, vocab_size)
    probs = g / g.sum(-1, keepdim=True)
    toks = torch.stack([
        torch.multinomial(probs[s], shard_size * (seq_len + 1),
                          replacement=True, generator=generator)
        for s in range(num_shards)]).reshape(num_shards, shard_size,
                                             seq_len + 1).to(dev)
    return {"tokens": toks[..., :-1].contiguous(),
            "labels": toks[..., 1:].contiguous()}


def susy_test_set(generator: torch.Generator, *, size=10_000, dim=18,
                  sep=1.2):
    data, _ = susy_shards(generator, num_shards=1, shard_size=size,
                          dim=dim, beta_a=1e6, sep=sep)
    return {"x": data["x"][0], "y": data["y"][0]}
