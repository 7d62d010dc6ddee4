"""The reference's side of ``tools/paper_runs.py``, on the CPU.

Runs the JAX package's benchmarks of the paper's own workloads
(``benchmarks/f1_linreg.py``, ``fig5_metric_learning.py``,
``remark1_alpha.py``, ``table1_bnn.py``) and writes, into ``--out``:

* ``reference.json``: their rows, name -> value, and ``<row>_n``, the
  repetitions behind each row. ``remark1_alpha.py`` runs one chain (seed
  2), whose MSE spreads as widely as its value across seeds (at alpha =
  0: 0.31 +- 0.43 over seeds 2-11, the benchmark's 1.33 in the tail), so
  its rows here are the mean and spread over seeds 2-11 of the same run,
  the benchmark's own kept as ``<row>_seed2``;
* ``f1.npz``, ``fig5.npz``, ``remark1.npz``, ``table1.npz``: the data
  those runs sampled, made again from the same keys and calls (Fig. 5 as
  its standardised pair features), so that ``tools/paper_runs.py --data
  DIR`` runs the port on the reference's own data and holds its rows
  against these.

    PYTHONPATH=src:. python tests/_paper_witness.py --out build/paper_data

About 3 minutes on 4 CPU cores; ~40 MB of data.

``--chains N`` (with ``--out``) instead runs the reference's Fig. 5 and
Table 1 samplers (100 rounds x 40 steps, and 250 x 40 at h = 1e-5) with N
chains each, on the same data and banks as the benchmarks (their keys),
and writes ``banks.npz`` (those banks' means and precisions, which
``tools/paper_runs.py --data`` samples with on the reference's data) and
``chains.json``: per row (``fig5/<method>_test_ll``,
``table1/<regime>_<method>_test_ll``) each chain's held-out
log-likelihood over its second half, ``null`` for a chain that diverged
(a non-finite state). ``tools/paper_runs.py --data DIR`` holds the port's
N-chain runs against these (~2 minutes at N = 48).

``--compare ROW --chains N [--seed S]`` runs one Table-1 row (e.g.
``noniid_dsgld``) in BOTH packages on the CPU, N chains each, on the
reference's data and bank, and prints each package's diverged chains and
median held-out ll and the Mann-Whitney p between them (~70 s at N =
48): whether a near miss of ``paper_runs.py``'s hold is the reference's
chains or the port.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks import f1_linreg, fig5_metric_learning, remark1_alpha
from benchmarks import table1_bnn
from repro import api
from repro.core import (analytic_gaussian_likelihood_surrogate,
                        fit_bank_fisher, make_bank, sample_local_likelihood)
from repro.data import (linreg_datasets, metric_pairs, metric_test_pairs,
                        susy_shards, susy_test_set)

REMARK1_SEEDS = range(2, 12)


def f1_data():
    sets = linreg_datasets(jax.random.PRNGKey(0))
    out = {}
    for name, ds in sets.items():
        out[f"{name}/x"] = np.asarray(ds["x"])
        out[f"{name}/y"] = np.asarray(ds["y"])
        out[f"{name}/sigma"] = np.float32(ds["sigma"])
    return out


def fig5_data():
    """fig5_metric_learning.run()'s features, its calls repeated."""
    key, K = jax.random.PRNGKey(0), fig5_metric_learning.K
    data, centers = metric_pairs(key, num_classes=20, dim=32, num_shards=10,
                                 pairs_per_shard=400, class_sep=1.5)
    xall = jnp.concatenate([data["xi"].reshape(-1, 32),
                            data["xj"].reshape(-1, 32)])
    _, vecs = jnp.linalg.eigh(jnp.cov(xall, rowvar=False))
    vecs = vecs[:, -K:]
    shards, z_scale = fig5_metric_learning._features(data, vecs)
    test, _ = fig5_metric_learning._features(
        metric_test_pairs(jax.random.fold_in(key, 9), centers,
                          num_pairs=600), vecs, z_scale)
    return {"shards_z": shards["z"], "shards_y": shards["y"],
            "test_z": test["z"], "test_y": test["y"]}


def remark1_data():
    key = jax.random.PRNGKey(0)
    S, n, d = 10, 200, 2
    mus = jax.random.uniform(key, (S, d), minval=-6, maxval=6)
    x = mus[:, None, :] + jax.random.normal(jax.random.fold_in(key, 1),
                                            (S, n, d))
    return {"x": x, "post_mean": x.reshape(-1, d).sum(0) / (1 + S * n)}


def remark1_rows(x, post_mean) -> dict:
    """remark1_alpha.py's run at seeds 2-11: each alpha's mean MSE and its
    population spread."""
    mu_s, prec_s = jax.vmap(analytic_gaussian_likelihood_surrogate)(x)
    bank = make_bank(mu_s, prec_s, "diag")
    rows = {}
    for alpha in (0.0, 0.25, 0.5, 1.0, 1.5):
        samp = api.FSGLD(
            api.Posterior(remark1_alpha.log_lik, prior_precision=1.0),
            {"x": x}, minibatch=10, step_size=1e-4, alpha=alpha,
            surrogate=api.SurrogateSpec(kind="diag", bank=bank),
            schedule=api.Schedule(rounds=200, local_steps=100, thin=10))
        mse = []
        for seed in REMARK1_SEEDS:
            tr = samp.sample(jax.random.PRNGKey(seed), jnp.zeros(2))[0]
            tr = tr[tr.shape[0] // 2:]
            mse.append(float(jnp.sum((tr.mean(0) - post_mean) ** 2)))
        name = f"remark1/alpha{alpha}_mse"
        rows[name], rows[f"{name}_std"] = float(np.mean(mse)), \
            float(np.std(mse))
        rows[f"{name}_n"] = len(mse)
        print(f"# {name} over seeds {list(REMARK1_SEEDS)}: {mse}",
              flush=True)
    return rows


def table1_data():
    key = jax.random.PRNGKey(0)
    test = susy_test_set(jax.random.fold_in(key, 7), size=4000)
    out = {"test_x": test["x"], "test_y": test["y"],
           "theta0": 0.1 * jax.random.normal(key, (table1_bnn.P,))}
    for regime, beta_a in (("iid", 100.0), ("noniid", 0.5)):
        shards, _ = susy_shards(jax.random.fold_in(key, 1), num_shards=10,
                                shard_size=20_000, beta_a=beta_a)
        out[f"{regime}_x"], out[f"{regime}_y"] = shards["x"], shards["y"]
    return out


def _chain_lls(trace, batch, avg_loglik) -> list:
    """Each chain's held-out ll over its second half; None if it
    diverged."""
    out = []
    for tr in np.asarray(trace):
        ok = bool(np.isfinite(tr).all())
        out.append(avg_loglik(jnp.asarray(tr[tr.shape[0] // 2:]), batch)
                   if ok else None)
    return out


def many_chains(n_chains: int) -> tuple[dict, dict]:
    """fig5_metric_learning.run()'s and table1_bnn.run()'s samplers, their
    data and banks made from the same keys, with ``n_chains`` chains each
    (seeds 10 and 20, their first repetitions' keys). Returns the rows and
    the banks' means and precisions."""
    rows, banks = {"n": n_chains}, {}
    key, K = jax.random.PRNGKey(0), fig5_metric_learning.K
    f5 = fig5_data()
    shards = {"z": f5["shards_z"], "y": f5["shards_y"]}
    test = {"z": f5["test_z"], "y": f5["test_y"]}
    samples = sample_local_likelihood(
        fig5_metric_learning.log_lik, shards, jnp.zeros(K + 1),
        jax.random.fold_in(key, 1), minibatch=64, step_size=1e-5,
        num_steps=600, burn_in=300, thin=2, prior_precision=0.1)
    bank = fit_bank_fisher(fig5_metric_learning.log_lik, shards,
                           samples.mean(1))
    banks["fig5_means"], banks["fig5_precs"] = bank.means, bank.precs
    for method in ("dsgld", "fsgld"):
        tr = _sampler(fig5_metric_learning.log_lik, shards, bank, method,
                      64, 100, n_chains).sample(jax.random.PRNGKey(10),
                                                jnp.zeros(K + 1))
        rows[f"fig5/{method}_test_ll"] = _chain_lls(
            tr, test, fig5_metric_learning.avg_loglik)
    t1 = table1_data()
    test = {"x": t1["test_x"], "y": t1["test_y"]}
    for regime in ("iid", "noniid"):
        shards, bank = table1_bank(t1, regime)
        banks[f"{regime}_means"], banks[f"{regime}_precs"] = bank.means, \
            bank.precs
        for method in ("dsgld", "fsgld"):
            tr = _sampler(table1_bnn.log_lik, shards, bank, method, 50, 250,
                          n_chains).sample(jax.random.PRNGKey(20),
                                           t1["theta0"])
            name = f"table1/{regime}_{method}_test_ll"
            rows[name] = _chain_lls(tr, test, table1_bnn.avg_loglik)
            print(f"# {name}: {rows[name]}", flush=True)
    return rows, banks


def table1_bank(t1: dict, regime: str):
    """table1_bnn.run()'s shards and Fisher bank of one regime."""
    shards = {"x": t1[f"{regime}_x"], "y": t1[f"{regime}_y"]}
    samples = sample_local_likelihood(
        table1_bnn.log_lik, shards, t1["theta0"],
        jax.random.fold_in(jax.random.PRNGKey(0), 2), minibatch=50,
        step_size=1e-5, num_steps=400, burn_in=200, thin=2,
        prior_precision=1.0)
    means = jax.tree.leaves(samples)[0].reshape(10, -1, table1_bnn.P).mean(1)
    return shards, fit_bank_fisher(table1_bnn.log_lik, shards, means)


def compare(row: str, n_chains: int, seed: int) -> None:
    """One Table-1 row (``<regime>_<method>``) in BOTH packages on the
    CPU, ``n_chains`` chains each from ``seed``, on the reference's data
    with the reference's bank: each package's diverged chains and median
    held-out ll, and the Mann-Whitney p of ``tools/paper_runs.py``."""
    import importlib.util

    import torch

    from repro_torch import api as tapi
    from repro_torch import workloads as W
    from repro_torch.core import make_bank as tmake_bank
    path = Path(__file__).resolve().parents[1] / "tools" / "paper_runs.py"
    spec = importlib.util.spec_from_file_location("paper_runs", path)
    P = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(P)
    regime, method = row.split("_")
    t1 = table1_data()
    shards, bank = table1_bank(t1, regime)
    lls = {"reference": _chain_lls(
        _sampler(table1_bnn.log_lik, shards, bank, method, 50, 250,
                 n_chains).sample(jax.random.PRNGKey(seed), t1["theta0"]),
        {"x": t1["test_x"], "y": t1["test_y"]}, table1_bnn.avg_loglik)}

    def tt(a):
        return torch.from_numpy(np.array(a))

    ttest = {"x": tt(t1["test_x"]), "y": tt(t1["test_y"])}
    tr = W.sampler(W.table1_log_lik, {k: tt(v) for k, v in shards.items()},
                   bank=tmake_bank(tt(bank.means), tt(bank.precs), "diag"),
                   method=method, minibatch=50, step_size=1e-5, rounds=250,
                   local_steps=40, thin=20, n_chains=n_chains,
                   execution=tapi.Execution(device="cpu")).sample(
        torch.Generator().manual_seed(seed), tt(t1["theta0"]))
    lls["port"] = [W.avg_loglik(c[c.shape[0] // 2:], ttest)
                   if bool(torch.isfinite(c).all()) else None for c in tr]
    for pkg, v in lls.items():
        print(f"# table1/{row} {pkg}: {sum(x is None for x in v)} of "
              f"{n_chains} diverged, median {P.ranked_median(v):.4f}",
              flush=True)
    p = P.mann_whitney(P.ranked(lls["port"]), P.ranked(lls["reference"]))
    print(f"# Mann-Whitney p {p:.3g}", flush=True)


def _sampler(log_lik, shards, bank, method, minibatch, rounds, n_chains):
    return api.FSGLD(
        api.Posterior(log_lik, prior_precision=1.0), shards,
        minibatch=minibatch, step_size=1e-5, method=method,
        surrogate=(api.SurrogateSpec(kind="diag", bank=bank)
                   if method == "fsgld" else api.SurrogateSpec(kind="none")),
        schedule=api.Schedule(rounds=rounds, local_steps=40, thin=20,
                              n_chains=n_chains))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path("build/paper_data"))
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--compare", default=None,
                    help="a Table-1 row, e.g. noniid_dsgld, in both "
                         "packages (with --chains N and --seed)")
    ap.add_argument("--seed", type=int, default=40)
    args = ap.parse_args()
    if args.compare:
        compare(args.compare, args.chains or 12, args.seed)
        return
    args.out.mkdir(parents=True, exist_ok=True)
    if args.chains:
        rows, banks = many_chains(args.chains)
        (args.out / "chains.json").write_text(json.dumps(rows, indent=1))
        np.savez(args.out / "banks.npz",
                 **{k: np.asarray(v) for k, v in banks.items()})
        return
    rows = {}
    for name, mod, data in (("f1", f1_linreg, f1_data),
                            ("fig5", fig5_metric_learning, fig5_data),
                            ("remark1", remark1_alpha, remark1_data),
                            ("table1", table1_bnn, table1_data)):
        t0 = time.perf_counter()
        for r in mod.run():
            rows[r.name] = r.derived
            print(r.csv(), flush=True)
            if r.name.endswith("_std"):
                rows[f"{r.name[:-4]}_n"] = 3
        arrays = data()
        if name == "remark1":
            for k in [k for k in rows if k.startswith("remark1/alpha")
                      and k.endswith("_mse")]:
                rows[f"{k}_seed2"] = rows[k]
            rows.update(remark1_rows(arrays["x"], arrays["post_mean"]))
        np.savez(args.out / f"{name}.npz",
                 **{k: np.asarray(v) for k, v in arrays.items()})
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    (args.out / "reference.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
