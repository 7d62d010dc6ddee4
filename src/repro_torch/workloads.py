"""The posteriors the port is driven with, in PyTorch.

* Table 1 of the paper (``benchmarks/table1_bnn.py`` in the JAX
  package): a Bayesian MLP 18 -> 18 -> 18 -> 8 -> 2 with ReLU and softmax
  on SUSY-like shards, all 854 parameters in one flat float32 vector.
* The multi-leaf MLP regression posterior of ``benchmarks/bench_chains.py``
  (tanh hidden layer, four leaves, a 'scalar' surrogate bank): the
  large-model runtime's parameter format.
"""
from __future__ import annotations

import torch

from repro_torch.core.surrogate import SurrogateBank, make_bank

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
