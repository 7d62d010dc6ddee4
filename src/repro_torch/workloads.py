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
* Remark 1's exploration knob alpha (``benchmarks/remark1_alpha.py``) on
  the Figs. 2-3 Gaussian with 100 local steps per round, and the linear
  (control-variate) surrogates of ``tests/test_extensions.py`` on it.
* App. F.1 Bayesian linear regression (``benchmarks/f1_linreg.py``) on
  the stand-ins of concrete / noise / conductivity, with the analytic
  per-shard surrogates.
* Fig. 5 Bayesian metric learning (``benchmarks/fig5_metric_learning.py``)
  on class-disjoint pair shards: logistic regression on the squared
  projections of pair differences on the data's top eigenvectors.
* The calibration problems of ``benchmarks/bench_calibration.py``:
  Bayesian logistic regression (ensemble NLL / ECE / Jensen gap) and
  linear regression (predictive-interval coverage, mixture NLL), with
  their absolute bounds.

The reference runs each of f1, Fig. 5 and Table 1 three times from three
seeds; the port runs the three repetitions as C = 3 independent chains of
one sampler (statistically the same, one host dispatch per step).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import api
from repro_torch.core.conducive import conducive_gradient_from_bank
from repro_torch.core.federated import (fit_bank_fisher, fit_bank_linear,
                                        sample_local_likelihood)
from repro_torch.core.surrogate import (SurrogateBank,
                                        analytic_gaussian_likelihood_surrogate,
                                        make_bank)
from repro_torch.data.synthetic import (gaussian_shards, metric_pairs,
                                        metric_test_pairs, split_shards)
from repro_torch.eval import (ece_binary, interval_coverage, nll_categorical,
                              nll_gaussian_mixture)

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


def sampler(log_lik, shards, *, bank=None, method="fsgld", minibatch: int,
            step_size: float, rounds: int, local_steps: int, thin: int,
            n_chains: int, execution, alpha: float = 1.0) -> api.FSGLD:
    """One of the paper's samplers through the facade (prior N(0, I)):
    FSGLD with the prefit ``bank`` (its kind), or the surrogate-free
    DSGLD / SGLD."""
    return api.FSGLD(
        api.Posterior(log_lik, prior_precision=1.0), shards,
        minibatch=minibatch, step_size=step_size, method=method,
        alpha=alpha,
        surrogate=(api.SurrogateSpec(kind=bank.kind, bank=bank)
                   if method == "fsgld" else None),
        schedule=api.Schedule(rounds=rounds, local_steps=local_steps,
                              n_chains=n_chains, thin=thin),
        execution=execution)


def sample_trace(label: str, sampler: api.FSGLD,
                 generator: torch.Generator, theta0) -> torch.Tensor:
    """The default ``run`` of the workload runners below: the sampler's
    (C, K, P) trace (``label`` names the run for runners that log)."""
    return sampler.sample(generator, theta0)


def _generator(execution, seed: int) -> torch.Generator:
    return torch.Generator(device=execution.device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Remark 1 and the linear surrogates (on the Figs. 2-3 Gaussian)
# ---------------------------------------------------------------------------

# remark1_alpha.py: 20,000 steps as rounds of 100 local steps, thin 10
REMARK1_ALPHAS = (0.0, 0.25, 0.5, 1.0, 1.5)
REMARK1_STEPS, REMARK1_T, REMARK1_THIN = 20_000, 100, 10


def remark1_claim(mse: dict) -> bool:
    """remark1_alpha.py's ``alpha1_best``: with exact surrogates alpha = 1
    is within 1.5x of the best MSE over the alphas."""
    return mse[1.0] <= min(mse.values()) * 1.5


# test_extensions.py's linear-surrogate run: the bank fitted at theta = 0
# in chunks of 50 rows, 100 rounds x 100 steps, thin 10
LINEAR_FIT_BATCH, LINEAR_ROUNDS, LINEAR_T, LINEAR_THIN = 50, 100, 100, 10
LINEAR_SUM_ATOL, LINEAR_MSE_CEILING = 1e-2, 5e-3


def linear_surrogate_problem(generator: torch.Generator):
    """The Figs. 2-3 Gaussian with a 'linear' bank fitted at theta = 0,
    and the f-weighted sum over clients of the conducive terms at theta =
    (1, ..., 1), which Lemma 1 makes 0. Returns (data, post_mean, bank,
    the sum)."""
    data, post_mean, _ = gaussian_problem(generator)
    S, d = data["x"].shape[0], data["x"].shape[2]
    dev = data["x"].device
    bank = fit_bank_linear(gaussian_log_lik, data,
                           torch.zeros(d, device=dev),
                           batch=LINEAR_FIT_BATCH)
    f = 1.0 / S
    total = sum(f * conducive_gradient_from_bank(
        torch.ones(d, device=dev), bank, s, f) for s in range(S))
    return data, post_mean, bank, total


# ---------------------------------------------------------------------------
# App. F.1: Bayesian linear regression
# ---------------------------------------------------------------------------

# f1_linreg.py: S shards of the 80% training split, minibatch, step size,
# rounds x local steps, thin; the test MSE over each chain's second half
F1_S, F1_M, F1_H, F1_ROUNDS, F1_T, F1_THIN = 10, 10, 1e-6, 100, 40, 20


def linreg_log_lik(sigma: float):
    """log p(y | x, theta) = -|y - x theta|^2 / (2 sigma^2), summed."""
    sig2 = float(sigma) ** 2

    def log_lik(theta, batch):
        r = batch["y"] - batch["x"] @ theta
        return -0.5 * torch.sum(r * r) / sig2

    return log_lik


def exact_linreg_surrogates(xs: torch.Tensor, ys: torch.Tensor,
                            sigma: float, jitter: float):
    """Each shard's exact likelihood surrogate for (S, n, d) inputs and
    (S, n) targets: precision X_s^T X_s / sigma^2 (S, d, d) and mean its
    least-squares solution against precision + jitter I (S, d)."""
    sig2 = float(sigma) ** 2
    prec = xs.transpose(1, 2) @ xs / sig2
    eye = torch.eye(xs.shape[2], device=xs.device)
    mus = torch.linalg.solve(prec + jitter * eye,
                             (xs.transpose(1, 2) @ ys[..., None])[..., 0]
                             / sig2)
    return mus, prec


def linreg_problem(ds: dict):
    """f1_linreg.py's split of one data set: the first 80% (a multiple of
    F1_S rows) as F1_S training shards, the rest as the test set, and the
    shards' exact surrogates (jitter 1e-6). Returns (shards, test, means
    (S, d), full precisions (S, d, d)); the benchmark's 'diag' bank keeps
    the precisions' diagonals."""
    n_train = int(0.8 * ds["x"].shape[0]) // F1_S * F1_S
    shards = split_shards({"x": ds["x"][:n_train], "y": ds["y"][:n_train]},
                          F1_S)
    test = {"x": ds["x"][n_train:], "y": ds["y"][n_train:]}
    mus, prec = exact_linreg_surrogates(shards["x"], shards["y"],
                                        ds["sigma"], 1e-6)
    return shards, test, mus, prec


def linreg_diag_bank(mus: torch.Tensor, prec: torch.Tensor) -> SurrogateBank:
    """The 'diag' bank of the exact surrogates' precision diagonals."""
    return make_bank(mus, torch.diagonal(prec, dim1=1, dim2=2), "diag")


def linreg_exact_mse(shards: dict, test: dict, sigma: float) -> float:
    """The test MSE of the exact posterior mean (prior N(0, I), all
    shards' likelihood): what a converged chain's predictive mean
    reaches."""
    x = shards["x"].reshape(-1, shards["x"].shape[-1])
    y = shards["y"].reshape(-1)
    sig2 = float(sigma) ** 2
    lam = torch.eye(x.shape[1], device=x.device) + x.T @ x / sig2
    mean = torch.linalg.solve(lam, x.T @ y / sig2)
    return float(((test["x"] @ mean - test["y"]) ** 2).mean())


def linreg_test_mse(trace: torch.Tensor, test: dict) -> list:
    """Per chain of ``trace`` (C, K, d): the test MSE of the posterior-
    predictive mean over the chain's second half."""
    half = trace[:, trace.shape[1] // 2:]
    pred = (half @ test["x"].T).mean(1)                        # (C, n)
    return ((pred - test["y"]) ** 2).mean(1).tolist()


def f1_sampler(ds: dict, shards: dict, bank: SurrogateBank, *, method: str,
               n_chains: int, execution, rounds: int = F1_ROUNDS):
    """f1_linreg.py's sampler on one data set's shards."""
    return sampler(linreg_log_lik(ds["sigma"]), shards, bank=bank,
                   method=method, minibatch=F1_M, step_size=F1_H,
                   rounds=rounds, local_steps=F1_T, thin=F1_THIN,
                   n_chains=n_chains, execution=execution)


def run_f1(ds: dict, *, n_chains: int, execution, run=sample_trace,
           seed: int = 30) -> dict:
    """f1_linreg.py on one data set: DSGLD and FSGLD from theta = 0, each
    chain scored by its test MSE. ``run(label, sampler, generator,
    theta0)`` returns a run's trace. Returns {'shards', 'test', 'bank',
    'exact' (the exact posterior mean's test MSE), 'dsgld', 'fsgld' (the
    per-chain test MSEs)}."""
    shards, test, mus, prec = linreg_problem(ds)
    out = {"shards": shards, "test": test,
           "bank": linreg_diag_bank(mus, prec),
           "exact": linreg_exact_mse(shards, test, ds["sigma"])}
    theta0 = torch.zeros(ds["x"].shape[1], device=execution.device)
    for method in ("dsgld", "fsgld"):
        tr = run(method, f1_sampler(ds, shards, out["bank"], method=method,
                                    n_chains=n_chains, execution=execution),
                 _generator(execution, seed), theta0)
        out[method] = linreg_test_mse(tr, test)
    return out


# ---------------------------------------------------------------------------
# Fig. 5: Bayesian metric learning
# ---------------------------------------------------------------------------

# fig5_metric_learning.py: K eigenvectors, the pair data, the local-SGLD
# fit, the sampler
FIG5_K, FIG5_S, FIG5_CLASSES, FIG5_DIM = 10, 10, 20, 32
FIG5_PAIRS, FIG5_SEP, FIG5_TEST_PAIRS = 400, 1.5, 600
FIG5_FIT_STEPS, FIG5_FIT_BURN, FIG5_FIT_THIN, FIG5_FIT_PRIOR = 600, 300, 2, 0.1
FIG5_M, FIG5_H, FIG5_ROUNDS, FIG5_T, FIG5_THIN = 64, 1e-5, 100, 40, 20


def metric_features(data: dict, vecs: torch.Tensor, z_scale=None):
    """Pair features z_k = ((x_i - x_j) . v_k)^2 on the K eigenvectors
    ``vecs`` (d, K), standardised by ``z_scale`` (default: their
    population std over the pairs, + 1e-6), and labels y in {-1, +1}.
    Squares make each eigenvector's sign irrelevant. Returns ({'z', 'y'},
    z_scale)."""
    z = ((data["xi"] - data["xj"]) @ vecs) ** 2
    if z_scale is None:
        z_scale = z.reshape(-1, vecs.shape[1]).std(0, correction=0) + 1e-6
    return {"z": z / z_scale, "y": 2.0 * data["y"] - 1.0}, z_scale


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log sigmoid(x) = -softplus(-x), as ``jax.nn.log_sigmoid`` computes
    it. (``F.logsigmoid`` raises under the Fisher fit's
    ``vmap(vmap(grad(...)))`` on CUDA with torch 2.11.)"""
    return -F.softplus(-x)


def metric_log_lik(theta, batch):
    """p(y | pair) = sigmoid(y (mu - sum_k gamma_k z_k)), theta = (gamma,
    mu): Bayesian logistic regression on the pair features."""
    k = batch["z"].shape[-1]
    logit = theta[k] - batch["z"] @ theta[:k]
    return torch.sum(log_sigmoid(batch["y"] * logit))


def metric_problem(generator: torch.Generator):
    """Fig. 5's data on the generator's device: class-disjoint pair shards
    (FIG5_CLASSES classes in FIG5_DIM dimensions, FIG5_S shards x
    FIG5_PAIRS pairs) and FIG5_TEST_PAIRS held-out pairs, as standardised
    features on the top FIG5_K eigenvectors of the pooled points'
    covariance. Returns (shards, test)."""
    data, centers = metric_pairs(generator, num_classes=FIG5_CLASSES,
                                 dim=FIG5_DIM, num_shards=FIG5_S,
                                 pairs_per_shard=FIG5_PAIRS,
                                 class_sep=FIG5_SEP)
    xall = torch.cat([data["xi"].reshape(-1, FIG5_DIM),
                      data["xj"].reshape(-1, FIG5_DIM)])
    _, vecs = torch.linalg.eigh(torch.cov(xall.T))
    vecs = vecs[:, -FIG5_K:]
    shards, z_scale = metric_features(data, vecs)
    test, _ = metric_features(metric_test_pairs(
        generator, centers, num_pairs=FIG5_TEST_PAIRS), vecs, z_scale)
    return shards, test


def metric_bank(generator: torch.Generator, shards: dict) -> SurrogateBank:
    """Fig. 5's surrogates: per-client SGLD against the local likelihood
    (tempered by a weak prior) from theta = 0, the kept steps' means, and
    the diagonal empirical Fisher at those means."""
    theta0 = torch.zeros(FIG5_K + 1, device=shards["z"].device)
    samples = sample_local_likelihood(
        metric_log_lik, shards, theta0, generator, minibatch=FIG5_M,
        step_size=FIG5_H, num_steps=FIG5_FIT_STEPS, burn_in=FIG5_FIT_BURN,
        thin=FIG5_FIT_THIN, prior_precision=FIG5_FIT_PRIOR)
    return fit_bank_fisher(metric_log_lik, shards, samples.mean(1))


def metric_avg_ll(trace: torch.Tensor, batch: dict) -> float:
    """The average log-likelihood per pair over the draws of ``trace``
    (K, P); ``batch`` holds (n, ...) pairs (``pooled`` turns shards into
    that)."""
    n = batch["y"].shape[0]
    return float(torch.stack([metric_log_lik(t, batch) / n
                              for t in trace]).mean())


def pooled(shards: dict) -> dict:
    """(S, n, ...) shard leaves -> (S * n, ...)."""
    return {k: v.reshape((-1,) + tuple(v.shape[2:]))
            for k, v in shards.items()}


def fig5_sampler(shards: dict, bank: SurrogateBank, *, method: str,
                 n_chains: int, execution, rounds: int = FIG5_ROUNDS):
    """fig5_metric_learning.py's sampler."""
    return sampler(metric_log_lik, shards, bank=bank, method=method,
                   minibatch=FIG5_M, step_size=FIG5_H, rounds=rounds,
                   local_steps=FIG5_T, thin=FIG5_THIN, n_chains=n_chains,
                   execution=execution)


def run_fig5(shards: dict, test: dict, bank: SurrogateBank, *,
             n_chains: int, execution, run=sample_trace,
             seed: int = 10) -> dict:
    """fig5_metric_learning.py's runs: DSGLD and FSGLD from theta = 0,
    each chain scored over its second half. ``run`` as in ``run_f1``.
    Returns {method: {'train': [...], 'test': [...]}} (per-chain average
    log-likelihoods on the pooled shards and on the test pairs)."""
    theta0 = torch.zeros(FIG5_K + 1, device=execution.device)
    train, out = pooled(shards), {}
    for method in ("dsgld", "fsgld"):
        tr = run(method, fig5_sampler(shards, bank, method=method,
                                      n_chains=n_chains,
                                      execution=execution),
                 _generator(execution, seed), theta0)
        half = tr[:, tr.shape[1] // 2:]
        out[method] = {"train": [metric_avg_ll(c, train) for c in half],
                       "test": [metric_avg_ll(c, test) for c in half]}
    return out


# ---------------------------------------------------------------------------
# calibration (bench_calibration.py)
# ---------------------------------------------------------------------------

CALIB_K_DRAWS = 16
LOGREG_NLL_CEILING = 0.55    # chance is log 2 ~ 0.693
LOGREG_ECE_CEILING = 0.12
JENSEN_GAP_FLOOR = 0.0       # exact inequality (float64 scoring)
LINREG_COVER_FLOOR = 0.82    # nominal 0.90
LINREG_COVER_CEILING = 0.97
LINREG_NLL_CEILING = 1.0
# Beyond bench_calibration.py's absolute bounds: each ensemble NLL within
# this many nats of the true weights' NLL on the same test points. A
# Bayesian predictive's expected excess over the truth is d / (2 n):
# 0.0025 (logistic) and 0.0039 (linear); the margin is ~10x that.
CALIB_TRUE_MARGIN = 0.03
# The true weights of bench_calibration.py's two problems (its draws from
# PRNGKey(11) and PRNGKey(23)). Its absolute bounds are properties of
# those problems: how far the labels are from chance sets the reachable
# NLL (a draw with |w| ~ 1 puts even the true weights' NLL above 0.55).
# So the port's problems keep them; points, labels and noise are the
# port's own draws.
CALIB_LOG_W = (-0.3098756670951843, -0.5729866027832031, 2.0144853591918945,
               -0.27530792355537415)
CALIB_LIN_W = (-2.2284488677978516, 1.0972034931182861, -0.1550571173429489,
               0.5047670602798462, -0.2518409788608551, -0.77531898021698,
               -1.6717307567596436, 1.2946370840072632)
# logistic regression: d, train, test, S, minibatch, step, rounds x local
# steps, thin (a Fisher bank at theta0)
CALIB_LOG = dict(d=4, n=800, n_test=400, S=4, m=50, h=2e-4, rounds=600,
                 T=5, thin=10)
# linear regression: the same plus the noise sigma and the draws kept
CALIB_LIN = dict(d=8, n=1024, n_test=500, S=4, sigma=0.5, m=64, h=5e-5,
                 rounds=600, T=5, thin=2, keep=128)


def calib_logreg_problem(generator: torch.Generator):
    """w = CALIB_LOG_W, x ~ N(0, I), y ~ Bernoulli(sigmoid(x w)): S
    training shards and a test set (labels int64)."""
    c, dev = CALIB_LOG, generator.device
    w = torch.tensor(CALIB_LOG_W, device=dev)

    def draw(n):
        x = torch.randn((n, c["d"]), generator=generator, device=dev)
        u = torch.rand(n, generator=generator, device=dev)
        return x, (u < torch.sigmoid(x @ w)).to(torch.float32)

    x, y = draw(c["n"])
    xt, yt = draw(c["n_test"])
    shards = {"x": x.reshape(c["S"], -1, c["d"]), "y": y.reshape(c["S"], -1)}
    return shards, {"x": xt, "y": yt.to(torch.int64)}


def logreg_log_lik(theta, batch):
    z = batch["x"] @ theta
    return torch.sum(batch["y"] * log_sigmoid(z)
                     + (1 - batch["y"]) * log_sigmoid(-z))


def _logreg_probs(draws: torch.Tensor, test: dict) -> np.ndarray:
    """(K, n, 2) class probabilities of (K, d) weight draws."""
    p1 = torch.sigmoid(draws @ test["x"].T).double().cpu().numpy()
    return np.stack([1.0 - p1, p1], -1)


def calib_logreg_scores(trace: torch.Tensor, test: dict) -> dict:
    """One chain's (K', d) trace scored on its last CALIB_K_DRAWS draws:
    ensemble NLL and ECE, the mean single-draw NLL, the Jensen gap (mean
    single NLL - ensemble NLL, >= 0) and the true weights' NLL."""
    two = _logreg_probs(trace[-CALIB_K_DRAWS:], test)
    yt = test["y"].cpu().numpy()
    ens = nll_categorical(two, yt)
    singles = [nll_categorical(two[k:k + 1], yt) for k in range(len(two))]
    w = torch.tensor(CALIB_LOG_W, device=trace.device)[None]
    return {"nll": ens, "single_nll": float(np.mean(singles)),
            "gap": float(np.mean(singles) - ens),
            "ece": ece_binary(two[..., 1], yt),
            "true_nll": nll_categorical(_logreg_probs(w, test), yt)}


def calib_linreg_problem(generator: torch.Generator):
    """w = CALIB_LIN_W, y = x w + sigma N(0, 1): S training shards, a test
    set and the analytic 'diag' bank (the exact surrogates, jitter 1)."""
    c, dev = CALIB_LIN, generator.device
    w = torch.tensor(CALIB_LIN_W, device=dev)

    def draw(n):
        x = torch.randn((n, c["d"]), generator=generator, device=dev)
        return x, x @ w + c["sigma"] * torch.randn(n, generator=generator,
                                                   device=dev)

    x, y = draw(c["n"])
    xt, yt = draw(c["n_test"])
    xs, ys = x.reshape(c["S"], -1, c["d"]), y.reshape(c["S"], -1)
    mus, prec = exact_linreg_surrogates(xs, ys, c["sigma"], 1.0)
    return {"x": xs, "y": ys}, {"x": xt, "y": yt}, \
        linreg_diag_bank(mus, prec)


def calib_linreg_scores(trace: torch.Tensor, test: dict,
                        generator: torch.Generator) -> dict:
    """One chain's (K', d) trace: its last CALIB_LIN['keep'] draws'
    posterior-predictive samples (one noise draw from ``generator`` per
    draw and test point) -> the central 90% interval's coverage, the
    predictive mixture's NLL and the true weights' NLL."""
    c = CALIB_LIN
    means = trace[-c["keep"]:] @ test["x"].T                   # (K, n)
    samples = means + c["sigma"] * torch.randn(
        means.shape, generator=generator, device=means.device)
    yt = test["y"].cpu().numpy()
    m = means.cpu().numpy()
    w = torch.tensor(CALIB_LIN_W, device=trace.device)
    t = (test["x"] @ w)[None].cpu().numpy()
    return {"coverage": interval_coverage(samples.cpu().numpy(), yt,
                                          level=0.9),
            "nll": nll_gaussian_mixture(m, np.full(m.shape, c["sigma"]),
                                        yt),
            "true_nll": nll_gaussian_mixture(t, np.full(t.shape,
                                                        c["sigma"]), yt)}


def calib_failures(logreg: dict, linreg: dict) -> list:
    """The bounds of bench_calibration.py that the scores break, and each
    ensemble NLL more than CALIB_TRUE_MARGIN above the true weights'."""
    bad = []
    for name, sc in (("logreg", logreg), ("mixture", linreg)):
        if not sc["nll"] <= sc["true_nll"] + CALIB_TRUE_MARGIN:
            bad.append(f"{name} NLL {sc['nll']} more than "
                       f"{CALIB_TRUE_MARGIN} above the true weights' "
                       f"{sc['true_nll']}")
    if not logreg["nll"] <= LOGREG_NLL_CEILING:
        bad.append(f"logreg NLL {logreg['nll']} > {LOGREG_NLL_CEILING}")
    if not logreg["ece"] <= LOGREG_ECE_CEILING:
        bad.append(f"logreg ECE {logreg['ece']} > {LOGREG_ECE_CEILING}")
    if not logreg["gap"] >= JENSEN_GAP_FLOOR:
        bad.append(f"Jensen gap {logreg['gap']} < {JENSEN_GAP_FLOOR}")
    if not LINREG_COVER_FLOOR <= linreg["coverage"] <= LINREG_COVER_CEILING:
        bad.append(f"coverage {linreg['coverage']} outside "
                   f"[{LINREG_COVER_FLOOR}, {LINREG_COVER_CEILING}]")
    if not linreg["nll"] <= LINREG_NLL_CEILING:
        bad.append(f"mixture NLL {linreg['nll']} > {LINREG_NLL_CEILING}")
    return bad
