"""Synthetic federated non-IID data generators (counterpart of
``repro.data.synthetic``), driven by an explicit ``torch.Generator`` and
built on the generator's device:

  * gaussian_shards — Sec 5.1: S shards from N(mu_s, I), mu_s ~ U[-s, s]^d
  * metric_pairs    — Sec 5.2: isolet-like Gaussian class clusters,
                      class-DISJOINT shards of similar/dissimilar pairs
  * susy_shards     — Sec 5.3: binary classification, per-shard label
                      proportions pi_s ~ Beta(a, a) (a=100 IID, 0.5 non-IID)
  * susy_test_set   — a balanced held-out set from the same classes
  * linreg_datasets — App F.1: three regression data sets matched in
                      (n, d) to concrete / noise / conductivity
  * token_shards    — federated non-IID token streams: each client's own
                      Dirichlet(alpha)-skewed unigram
  * make_batch      — a random batch for an (arch, input-shape) pair, with
                      the vlm / audio families' stubbed frontend output

The numbers differ from the JAX package's (another generator); the
structure is the same.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as tu


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


def _pairs(generator, centers, c_sim, c1, c2):
    """Half similar pairs (two draws of class ``c_sim``), half dissimilar
    (one of ``c1``, one of ``c2``): (xi, xj, y), y = 1 similar. Draws
    the four blocks of unit normals in the order xi_s, xj_s, xi_d, xj_d."""
    dev = generator.device
    half, dim = c_sim.shape[0], centers.shape[1]

    def draw(c):
        return centers[c] + torch.randn((half, dim), generator=generator,
                                        device=dev)

    xi_s, xj_s, xi_d, xj_d = draw(c_sim), draw(c_sim), draw(c1), draw(c2)
    y = torch.cat([torch.ones(half, device=dev),
                   torch.zeros(half, device=dev)])
    return {"xi": torch.cat([xi_s, xi_d]), "xj": torch.cat([xj_s, xj_d]),
            "y": y}


def metric_pairs(generator: torch.Generator, *, num_classes=26, dim=64,
                 num_shards=10, pairs_per_shard=1000, class_sep=2.0):
    """Isolet-like: Gaussian clusters per class, centres N(0, class_sep^2
    I); shard s owns classes [s * k, (s + 1) * k), k = num_classes //
    num_shards (class-DISJOINT shards, the paper's federated non-IID
    construction), and holds pairs_per_shard // 2 similar pairs (two draws
    of one of its classes) then as many dissimilar ones (two distinct
    classes of the shard). Returns ({'xi', 'xj': (S, pairs, dim), 'y':
    (S, pairs)}, centers (num_classes, dim)). Draws the centres, then per
    shard the similar classes, the dissimilar classes and offsets, and the
    pair points (``_pairs``)."""
    if not (num_classes % num_shards == 0 or num_classes >= num_shards):
        raise ValueError(f"{num_classes} classes cannot be split over "
                         f"{num_shards} shards")
    dev = generator.device
    centers = torch.randn((num_classes, dim), generator=generator,
                          device=dev) * class_sep
    per_shard = num_classes // num_shards
    half = pairs_per_shard // 2
    shards = []
    for s in range(num_shards):
        first = s * per_shard
        c_sim = first + torch.randint(0, per_shard, (half,),
                                      generator=generator, device=dev)
        c1 = torch.randint(0, per_shard, (half,), generator=generator,
                           device=dev)
        off = torch.randint(1, per_shard, (half,), generator=generator,
                            device=dev) if per_shard > 1 else \
            torch.zeros(half, dtype=torch.int64, device=dev)
        c2 = first + (c1 + off) % per_shard
        shards.append(_pairs(generator, centers, c_sim, first + c1, c2))
    data = {k: torch.stack([sh[k] for sh in shards]) for k in shards[0]}
    return data, centers


def metric_test_pairs(generator: torch.Generator, centers: torch.Tensor, *,
                      num_pairs=1000):
    """Held-out pairs over ALL classes: half similar, half dissimilar (two
    distinct classes). Returns {'xi', 'xj': (num_pairs, dim), 'y'}."""
    dev = generator.device
    num_classes = centers.shape[0]
    half = num_pairs // 2
    c_sim = torch.randint(0, num_classes, (half,), generator=generator,
                          device=dev)
    c1 = torch.randint(0, num_classes, (half,), generator=generator,
                       device=dev)
    c2 = (c1 + torch.randint(1, num_classes, (half,), generator=generator,
                             device=dev)) % num_classes
    return _pairs(generator, centers, c_sim, c1, c2)


# (name, n, d, noise sigma) of the App. F.1 data sets' stand-ins
LINREG_SPECS = (("concrete", 1030, 9, 0.3), ("noise", 1503, 6, 0.8),
                ("conductivity", 17389, 81, 0.5))


def linreg_datasets(generator: torch.Generator) -> dict:
    """Three synthetic stand-ins for concrete / noise / conductivity,
    (name, n, d) matched: per set a true beta ~ N(0, I_d), x ~ N(0, I),
    y = x beta + sigma * N(0, 1). Returns {name: {'x', 'y', 'beta',
    'sigma'}}, the sets drawn in ``LINREG_SPECS`` order (beta, x, the
    noise)."""
    dev = generator.device
    out = {}
    for name, n, d, sig in LINREG_SPECS:
        beta = torch.randn(d, generator=generator, device=dev)
        x = torch.randn((n, d), generator=generator, device=dev)
        y = x @ beta + sig * torch.randn(n, generator=generator, device=dev)
        out[name] = {"x": x, "y": y, "beta": beta, "sigma": sig}
    return out


def split_shards(data, num_shards: int):
    """Split a pytree of (N, ...) tensors into (S, N // S, ...) shard
    stacks, dropping the last N mod S rows."""
    def sp(a):
        n = a.shape[0] // num_shards * num_shards
        return a[:n].reshape((num_shards, -1) + tuple(a.shape[1:]))
    return tu.tree_map(sp, data)


def make_batch(cfg, shape, generator: torch.Generator,
               dtype=torch.int32) -> dict:
    """A random batch for an (arch, input-shape) pair: 'tokens' and
    'labels' (global_batch, seq_len) uniform over the vocabulary in
    ``dtype``, and for the vlm and audio families 'enc_embeds' (the
    stubbed frontend's output: num_patches image patches or encoder_seq
    audio frames of width d_model) as bf16 standard normals. The
    reference's shapes and dtypes; its draws share one key, so its tokens
    and labels are equal, where these are drawn in turn from
    ``generator`` (tokens, labels, then the embeddings)."""
    dev = generator.device
    B, S = shape.global_batch, shape.seq_len
    batch = {n: torch.randint(0, cfg.vocab_size, (B, S), generator=generator,
                              device=dev, dtype=dtype)
             for n in ("tokens", "labels")}
    if cfg.family in ("vlm", "audio"):
        T = cfg.num_patches if cfg.family == "vlm" else cfg.encoder_seq
        batch["enc_embeds"] = torch.randn(
            (B, T, cfg.d_model), generator=generator,
            device=dev).to(torch.bfloat16)
    return batch
