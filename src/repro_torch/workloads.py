"""The posteriors the port is driven with, in PyTorch.

* Table 1 of the paper (``benchmarks/table1_bnn.py`` in the JAX
  package): a Bayesian MLP 18 -> 18 -> 18 -> 8 -> 2 with ReLU and softmax
  on SUSY-like shards, all 854 parameters in one flat float32 vector.
* The multi-leaf MLP regression posterior of ``benchmarks/bench_chains.py``
  (tanh hidden layer, four leaves, a 'scalar' surrogate bank): the
  large-model runtime's parameter format.
* The Gaussian mean of the paper's Figs. 2-3
  (``benchmarks/fig2_3_gaussian.py``): S = 10 clients of 200 points from
  N(mu_s, I), mu_s ~ U[-6, 6]^2, h = 1e-4, m = 10, with analytic
  likelihood surrogates, and its delayed-communication contrast.
* The rival-sampler frontier of ``benchmarks/bench_frontier.py``: the
  same posterior at d = 64, methods x communication scenarios.
"""
from __future__ import annotations

import torch

from repro_torch.core.surrogate import (SurrogateBank,
                                        analytic_gaussian_likelihood_surrogate,
                                        make_bank)
from repro_torch.data.synthetic import gaussian_shards

TABLE1_DIM = 18
TABLE1_SIZES = ((TABLE1_DIM, 18), (18, 18), (18, 8), (8, 2))


def _offsets():
    offs, o = [], 0
    for a, b in TABLE1_SIZES:
        offs.append((o, o + a * b, o + a * b + b))
        o += a * b + b
    return tuple(offs), o


TABLE1_OFFS, TABLE1_P = _offsets()  # P = 854


def table1_logits(theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, (a, b) in enumerate(TABLE1_SIZES):
        w0, b0, b1 = TABLE1_OFFS[i]
        h = h @ theta[w0:b0].reshape(a, b) + theta[b0:b1]
        if i + 1 < len(TABLE1_SIZES):
            h = torch.relu(h)
    return h


def table1_log_lik(theta: torch.Tensor, batch) -> torch.Tensor:
    """Summed log-likelihood of the labels under the softmax MLP."""
    lp = torch.log_softmax(table1_logits(theta, batch["x"]), dim=-1)
    y = batch["y"].to(torch.int64)
    return torch.gather(lp, -1, y[..., None]).sum()


def avg_loglik(trace: torch.Tensor, batch, max_samples: int = 60) -> float:
    """Held-out average log-likelihood per point over (up to max_samples
    of) the draws in ``trace`` (N, P)."""
    tr = trace[::max(1, trace.shape[0] // max_samples)]
    n = batch["y"].shape[0]
    return float(torch.stack([table1_log_lik(t, batch) / n
                              for t in tr]).mean())


def mlp_problem(generator: torch.Generator, S: int, n: int, din: int,
                hid: int, dout: int):
    """bench_chains' multi-leaf regression posterior: data, a 'scalar'
    bank and theta0, made from ``generator`` on its device."""
    dev = generator.device
    rn = lambda *s: torch.randn(s, generator=generator,  # noqa: E731
                                device=dev)
    x = rn(S, n, din)
    w_true = rn(din, dout) / din ** 0.5
    y = x @ w_true + 0.1 * rn(S, n, dout)
    theta0 = {"w1": rn(din, hid) / din ** 0.5,
              "b1": torch.zeros(hid, device=dev),
              "w2": rn(hid, dout) / hid ** 0.5,
              "b2": torch.zeros(dout, device=dev)}
    means = {k: v[None] + 0.01 * rn(S, *v.shape) for k, v in theta0.items()}
    precs = {k: torch.linspace(1.0, 2.0, S, device=dev) for k in theta0}
    bank: SurrogateBank = make_bank(means, precs, "scalar")
    return {"x": x, "y": y}, bank, theta0


def mlp_log_lik(theta, batch) -> torch.Tensor:
    h = torch.tanh(batch["x"] @ theta["w1"] + theta["b1"])
    pred = h @ theta["w2"] + theta["b2"]
    return -0.5 * torch.sum((batch["y"] - pred) ** 2)


# Figs. 2-3: (method, registry scenario) of the delayed-communication
# contrast; one local step per round, so ``delayed-kx`` is k shard-local
# updates between reassignments (the figures' x-axis)
FIG2_3_S, FIG2_3_N, FIG2_3_D, FIG2_3_M, FIG2_3_H = 10, 200, 2, 10, 1e-4
FIG2_3_CASES = (("dsgld", "identity"), ("dsgld", "delayed-10x"),
                ("dsgld", "delayed-100x"), ("fsgld", "identity"),
                ("fsgld", "delayed-100x"))

# the frontier grid: every method crossed with the communication axis
FRONTIER_S, FRONTIER_N, FRONTIER_D = 10, 200, 64
FRONTIER_METHODS = ("dsgld", "fsgld", "fald")
FRONTIER_SCENARIOS = ("identity", "delayed-5x", "elf-bidir-qsgd-8bit")


def gaussian_problem(generator: torch.Generator, *, num_shards=FIG2_3_S,
                     shard_size=FIG2_3_N, dim=FIG2_3_D):
    """The Figs. 2-3 / frontier Gaussian-mean posterior (prior N(0, I)):
    data {"x": (S, n, d)}, the analytic posterior mean sum(x) / (1 + N)
    and the 'diag' bank of the clients' exact likelihood surrogates, made
    from ``generator`` on its device."""
    data, _ = gaussian_shards(generator, num_shards=num_shards,
                              shard_size=shard_size, dim=dim, spread=6.0)
    x = data["x"]
    post_mean = x.reshape(-1, dim).sum(0) / (1 + num_shards * shard_size)
    mu_s, prec_s = torch.vmap(analytic_gaussian_likelihood_surrogate)(x)
    return data, post_mean, make_bank(mu_s, prec_s, "diag")


def gaussian_log_lik(theta, batch) -> torch.Tensor:
    return -0.5 * torch.sum((batch["x"] - theta) ** 2)


def chain_mse(trace: torch.Tensor, post_mean: torch.Tensor) -> float:
    """The posterior-mean MSE of ONE chain, averaged over the chains of
    ``trace`` (C, K, d): each chain's mean over its second half against
    ``post_mean``. Its expectation is the single-chain MSE of
    ``fig2_3_gaussian.py``; more chains only narrow its spread (pooling
    the chains first would average the clients' local posteriors that
    DSGLD collapses onto)."""
    half = trace[:, trace.shape[1] // 2:]
    return float(((half.mean(1) - post_mean) ** 2).sum(-1).mean())


def fig2_3_claims(mse: dict) -> dict:
    """The three claims of ``fig2_3_gaussian.py`` over posterior-mean
    MSEs keyed (method, scenario)."""
    return {
        "dsgld_degrades_with_delay":
            mse["dsgld", "delayed-100x"] > 5 * mse["dsgld", "identity"],
        "fsgld_insensitive_to_delay":
            mse["fsgld", "delayed-100x"]
            < 3 * max(mse["fsgld", "identity"], 1e-5),
        "fsgld_beats_dsgld_at_100x":
            mse["fsgld", "delayed-100x"] < 0.1 * mse["dsgld", "delayed-100x"],
    }
