"""Full-length runs of the paper's own workloads on one CUDA card, through
``repro_torch.api``, at the lengths of the JAX package's benchmarks:

* f1 (``benchmarks/f1_linreg.py``): concrete / noise / conductivity,
  DSGLD and FSGLD, 100 rounds x 40 steps, the test MSE;
* Fig. 5 (``benchmarks/fig5_metric_learning.py``): 100 rounds x 40 steps,
  train / test log-likelihood, ``fsgld_beats_dsgld_test``;
* Remark 1 (``benchmarks/remark1_alpha.py``): 20,000 steps per alpha in
  (0, 0.25, 0.5, 1, 1.5), the posterior-mean MSE, ``alpha1_best``;
* Table 1 (``benchmarks/table1_bnn.py``): IID and non-IID SUSY-like
  shards, 250 rounds x 40 steps, held-out log-likelihood,
  ``noniid_fsgld_beats_dsgld`` and ``iid_parity_gap``.

The reference repeats f1, Fig. 5 and Table 1 from 3 seeds. Here f1 and
Remark 1 run ``REPS`` = 3 independent chains of one sampler (statistically
the same as 3 seeds), each row the mean (``_std``: the population spread)
over them. Fig. 5 and Table 1 run ``CHAINS`` = 48 chains: their claims are
differences below the noise of 3 repetitions, and Table 1's chains
diverge. A diverged chain (a non-finite state) is counted
(``_diverged``), left out of a row's mean and ranked below every finite
chain in its median (``_median``).

    python3 tools/paper_runs.py [--only f1,fig5,remark1,table1]
                                [--data DIR] [--json PATH]

Every workload runs on the port's own data (its generators, seeded as
below), with the port's own surrogate fits. With ``--data DIR`` (written
by ``tests/_paper_witness.py --out DIR`` and ``--out DIR --chains 48``)
each one runs a second time on the reference's data, with the
reference's Fig. 5 and Table 1 banks, and is held against the reference:

* a row of means (f1, Fig. 5, Remark 1): no chain diverged (the
  reference's rows are finite over every repetition), and the difference
  of the means within ``HOLD`` standard errors of it (from both sides'
  spreads over their repetitions, the port's where the benchmark prints
  none, floor ``HOLD_FLOOR`` of the row's magnitude);
* a row of chains (Fig. 5's and Table 1's held-out log-likelihoods,
  against the reference's chains in ``chains.json``): the port's
  diverged chains not more than the reference's (one-sided Fisher exact
  test), and the port's chains not shifted from the reference's
  (two-sided Mann-Whitney U test, diverged chains ranked last), each at
  p >= ``P_HOLD``;
* a claim: ``alpha1_best`` as the reference meets it; Fig. 5's (means) and
  Table 1's (medians) over the chains, asserted where the reference's
  chains meet them and reported where they do not.

Prints ``name,value`` rows and the card's name and power limit; exits 1
when a workload fails or a held row or claim misses.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPS, CHAINS = 3, 48
HOLD, HOLD_FLOOR, P_HOLD = 5.0, 1e-3, 0.005
# table1_bnn.py: S clients of N points, minibatch, step size, rounds x
# local steps, thin
T1_S, T1_N, T1_M, T1_H, T1_ROUNDS, T1_T, T1_THIN = 10, 20_000, 50, 1e-5, \
    250, 40, 20
WORKLOADS = ("f1", "fig5", "remark1", "table1")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Rows:
    """``name -> (mean, population std of the finite values, every
    value)``; a diverged chain's value is not finite."""

    def __init__(self, tag: str):
        self.tag, self.rows = tag, {}

    def add(self, name: str, values, median: bool = False) -> None:
        vals = [float(v) for v in values]
        ok = [v for v in vals if math.isfinite(v)]
        mean = statistics.fmean(ok) if ok else math.nan
        std = statistics.pstdev(ok) if len(ok) > 1 else 0.0
        self.rows[name] = (mean, std, vals)
        print(f"{self.tag}{name},{mean:.6g}", flush=True)
        if len(vals) > 1:
            print(f"{self.tag}{name}_std,{std:.6g}", flush=True)
        if median:
            print(f"{self.tag}{name}_median,{ranked_median(vals):.6g}",
                  flush=True)
        if len(ok) < len(vals):
            print(f"{self.tag}{name}_diverged,{len(vals) - len(ok)}",
                  flush=True)

    def flag(self, name: str, value: bool) -> None:
        self.rows[name] = (float(value), 0.0, [float(value)])
        print(f"{self.tag}{name},{float(value):g}", flush=True)


def ranked(values) -> list:
    """Values with a diverged chain's (non-finite, or None) as -inf."""
    return [v if v is not None and math.isfinite(v) else -math.inf
            for v in values]


def ranked_median(values) -> float:
    return statistics.median(ranked(values))


def fisher_greater(k1: int, n1: int, k2: int, n2: int) -> float:
    """One-sided Fisher exact p that k1 of n1 is a higher rate than k2 of
    n2: P(X >= k1), X hypergeometric with the k1 + k2 events among the
    n1 + n2 draws."""
    k, n = k1 + k2, n1 + n2
    return sum(math.comb(k, x) * math.comb(n - k, n1 - x)
               for x in range(k1, min(k, n1) + 1)) / math.comb(n, n1)


def mann_whitney(a, b) -> float:
    """Two-sided p of the Mann-Whitney U test of ``a`` against ``b``
    (normal approximation with the tie correction and a continuity
    correction); 1 when every value ties."""
    pooled = sorted((v, i) for i, v in enumerate(list(a) + list(b)))
    ranks, i, ties = [0.0] * len(pooled), 0, 0.0
    while i < len(pooled):
        j = i
        while j + 1 < len(pooled) and pooled[j + 1][0] == pooled[i][0]:
            j += 1
        for t in range(i, j + 1):
            ranks[pooled[t][1]] = (i + j) / 2 + 1
        ties += (j - i + 1) ** 3 - (j - i + 1)
        i = j + 1
    n1, n2 = len(a), len(b)
    n = n1 + n2
    u = sum(ranks[:n1]) - n1 * (n1 + 1) / 2
    var = n1 * n2 / 12 * ((n + 1) - ties / (n * (n - 1)))
    if var <= 0:
        return 1.0
    z = max(abs(u - n1 * n2 / 2) - 0.5, 0.0) / math.sqrt(var)
    return math.erfc(z / math.sqrt(2))


def _timed(label, sampler, gen, theta0):
    """A workload runner's ``run``: the (C, K, P) trace, timed."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sampler.sample(gen, theta0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sched = sampler.schedule
    steps = sched.rounds * sched.local_steps
    bad = int((~torch.isfinite(out).reshape(out.shape[0], -1).all(1)).sum())
    print(f"#   {label}: {steps} steps x {out.shape[0]} chains in {dt:.2f} "
          f"s, {steps * out.shape[0] / dt:.1f} chain-steps/s"
          + (f"; {bad} chain(s) diverged" if bad else ""), flush=True)
    return out


def _exec(dev):
    from repro_torch import api
    return api.Execution(device=dev)


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def run_f1(dev, rows, data=None):
    from repro_torch import workloads as W
    from repro_torch.data import linreg_datasets
    sets = linreg_datasets(_gen(dev, 0)) if data is None else data["f1"]
    for name, ds in sets.items():
        res = W.run_f1(ds, n_chains=REPS, execution=_exec(dev), run=_timed)
        print(f"# f1/{name}: exact posterior mean's test MSE "
              f"{res['exact']:.6f}", flush=True)
        for method in ("dsgld", "fsgld"):
            rows.add(f"f1/{name}_{method}_test_mse", res[method])
        rows.flag(f"f1/{name}_fsgld_lower_mse",
                  statistics.fmean(res["fsgld"])
                  < statistics.fmean(res["dsgld"]))
        rows.flag(f"f1/{name}_fsgld_lower_std",
                  statistics.pstdev(res["fsgld"])
                  < statistics.pstdev(res["dsgld"]))


def run_fig5(dev, rows, data=None):
    from repro_torch import workloads as W
    if data is None:
        shards, test = W.metric_problem(_gen(dev, 0))
        bank = W.metric_bank(_gen(dev, 1), shards)
    else:
        shards, test = data["fig5"]
        bank = data["banks"]["fig5"]
    res = W.run_fig5(shards, test, bank, n_chains=CHAINS,
                     execution=_exec(dev), run=_timed)
    for method, ll in res.items():
        rows.add(f"fig5/{method}_train_ll", ll["train"])
        rows.add(f"fig5/{method}_test_ll", ll["test"], median=True)
    rows.flag("fig5/fsgld_beats_dsgld_test",
              statistics.fmean(res["fsgld"]["test"])
              >= statistics.fmean(res["dsgld"]["test"]))


def run_remark1(dev, rows, data=None):
    from repro_torch import workloads as W
    from repro_torch.core import (analytic_gaussian_likelihood_surrogate,
                                  make_bank)
    if data is None:
        x, post, bank = W.gaussian_problem(_gen(dev, 0))
        x = x["x"]
    else:
        x, post = data["remark1"]
        mu_s, prec_s = torch.vmap(analytic_gaussian_likelihood_surrogate)(x)
        bank = make_bank(mu_s, prec_s, "diag")
    mse = {}
    for alpha in W.REMARK1_ALPHAS:
        s = W.sampler(W.gaussian_log_lik, {"x": x}, bank=bank, alpha=alpha,
                      minibatch=10, step_size=1e-4,
                      rounds=W.REMARK1_STEPS // W.REMARK1_T,
                      local_steps=W.REMARK1_T, thin=W.REMARK1_THIN,
                      n_chains=REPS, execution=_exec(dev))
        tr = _timed(f"alpha {alpha}", s, _gen(dev, 2),
                    torch.zeros(x.shape[2], device=dev))
        half = tr[:, tr.shape[1] // 2:]
        per = ((half.mean(1) - post) ** 2).sum(-1).tolist()
        rows.add(f"remark1/alpha{alpha}_mse", per)
        mse[alpha] = statistics.fmean(per)
    rows.flag("remark1/alpha1_best", W.remark1_claim(mse))


def run_table1(dev, rows, data=None):
    from repro_torch.core import fit_bank_fisher, sample_local_likelihood
    from repro_torch.data import susy_shards, susy_test_set
    from repro_torch import workloads as W
    test = (susy_test_set(_gen(dev, 7), size=4000) if data is None
            else data["table1"]["test"])
    med = {}
    for regime, beta_a in (("iid", 100.0), ("noniid", 0.5)):
        if data is None:
            g = _gen(dev, 1)
            shards, _ = susy_shards(g, num_shards=T1_S, shard_size=T1_N,
                                    beta_a=beta_a)
            theta0 = 0.1 * torch.randn(W.TABLE1_P, generator=g, device=dev)
            samples = sample_local_likelihood(
                W.table1_log_lik, shards, theta0, g, minibatch=T1_M,
                step_size=T1_H, num_steps=400, burn_in=200, thin=2,
                prior_precision=1.0)
            bank = fit_bank_fisher(W.table1_log_lik, shards,
                                   samples.mean(1), batch=2000)
        else:
            shards = data["table1"][regime]
            theta0 = data["table1"]["theta0"]
            bank = data["banks"][regime]
        for method in ("dsgld", "fsgld"):
            s = W.sampler(W.table1_log_lik, shards, bank=bank, method=method,
                          minibatch=T1_M, step_size=T1_H, rounds=T1_ROUNDS,
                          local_steps=T1_T, thin=T1_THIN, n_chains=CHAINS,
                          execution=_exec(dev))
            tr = _timed(f"{regime} {method}", s, _gen(dev, 20), theta0)
            vals = [W.avg_loglik(c[c.shape[0] // 2:], test)
                    if bool(torch.isfinite(c).all()) else math.nan
                    for c in tr]
            rows.add(f"table1/{regime}_{method}_test_ll", vals, median=True)
            med[regime, method] = ranked_median(vals)
    rows.flag("table1/noniid_fsgld_beats_dsgld",
              med["noniid", "fsgld"] >= med["noniid", "dsgld"])
    print(f"{rows.tag}table1/iid_parity_gap_median,"
          f"{abs(med['iid', 'fsgld'] - med['iid', 'dsgld']):.6g}",
          flush=True)


def load_data(root: Path, dev):
    """The reference's data sets and its Fig. 5 and Table 1 banks as
    ``tests/_paper_witness.py`` wrote them, on ``dev``."""
    from repro_torch.core import make_bank

    def npz(name):
        with np.load(root / f"{name}.npz") as f:
            return {k: torch.from_numpy(f[k]).to(dev) for k in f.files}

    f1 = npz("f1")
    names = sorted({k.split("/")[0] for k in f1})
    fig5, rem, t1, banks = (npz("fig5"), npz("remark1"), npz("table1"),
                            npz("banks"))
    return {
        "f1": {n: {"x": f1[f"{n}/x"], "y": f1[f"{n}/y"],
                   "sigma": float(f1[f"{n}/sigma"])} for n in names},
        "fig5": ({"z": fig5["shards_z"], "y": fig5["shards_y"]},
                 {"z": fig5["test_z"], "y": fig5["test_y"]}),
        "remark1": (rem["x"], rem["post_mean"]),
        "table1": {"iid": {"x": t1["iid_x"], "y": t1["iid_y"]},
                   "noniid": {"x": t1["noniid_x"], "y": t1["noniid_y"]},
                   "test": {"x": t1["test_x"], "y": t1["test_y"]},
                   "theta0": t1["theta0"]},
        "banks": {k: make_bank(banks[f"{k}_means"], banks[f"{k}_precs"],
                               "diag") for k in ("fig5", "iid", "noniid")},
    }


# the claims over the chains: (the statistic, the rows it compares)
CLAIMS = {"fig5/fsgld_beats_dsgld_test":
          (statistics.fmean, "fig5/fsgld_test_ll", "fig5/dsgld_test_ll"),
          "table1/noniid_fsgld_beats_dsgld":
          (ranked_median, "table1/noniid_fsgld_test_ll",
           "table1/noniid_dsgld_test_ll")}


def _verdict(ok: bool) -> str:
    return "held" if ok else "MISSED"


def hold(ours: Rows, ref: dict, chains: dict) -> list:
    """The rows and claims of ``ours`` (on the reference's data) that stray
    from the reference's rows ``ref`` (name -> value) and its many-chain
    rows ``chains`` (name -> per-chain values, None where a chain
    diverged)."""
    bad = []
    for name, (mean, std, vals) in ours.rows.items():
        if name in chains:
            theirs = chains[name]
            k1 = sum(not math.isfinite(v) for v in vals)
            k2 = sum(v is None for v in theirs)
            p_div = fisher_greater(k1, len(vals), k2, len(theirs))
            p_mw = mann_whitney(ranked(vals), ranked(theirs))
            ok = min(p_div, p_mw) >= P_HOLD
            print(f"# {name} over chains: port median "
                  f"{ranked_median(vals):.6g}, {k1} of {len(vals)} "
                  f"diverged; reference median {ranked_median(theirs):.6g},"
                  f" {k2} of {len(theirs)}; p {p_div:.3g} (more diverged),"
                  f" {p_mw:.3g} (shifted), floor {P_HOLD}: {_verdict(ok)}",
                  flush=True)
            if not ok:
                bad.append(f"{name} (chains)")
        if name in CLAIMS:
            stat, a, b = CLAIMS[name]
            met = stat(ranked(chains[a])) >= stat(ranked(chains[b]))
            ok = mean == 1.0 or not met
            print(f"# {name}: port {mean:g}, the reference's "
                  f"{chains['n']} chains {float(met):g}, its 3 seeds "
                  f"{ref[name]:g}: "
                  + (_verdict(ok) if met else "reported, not asserted "
                     "(the reference's chains miss it)"), flush=True)
        elif name.endswith("_best"):
            ok = mean >= ref[name]
            print(f"# {name}: port {mean:g}, reference {ref[name]:g}: "
                  f"{_verdict(ok)}", flush=True)
        elif name in ref and not name.startswith("table1/"):
            # a row of means; Table 1's rows are held over chains above
            want = ref[name]
            diverged = sum(not math.isfinite(v) for v in vals)
            # a benchmark row printed without its spread (Fig. 5's train
            # ll): the port's chains, which sample the same posterior,
            # stand in for the spread of its repetitions
            ref_std = ref.get(f"{name}_std", std)
            ref_n = ref.get(f"{name}_n", REPS)
            se = math.sqrt(std ** 2 / max(len(vals) - 1, 1)
                           + ref_std ** 2 / (ref_n - 1))
            bound = max(HOLD * se, HOLD_FLOOR * abs(want))
            ok = abs(mean - want) <= bound and not diverged
            print(f"# {name}: port {mean:.6g}, reference {want:.6g}, "
                  f"difference {mean - want:.3g} within {bound:.3g}"
                  + (f", {diverged} chain(s) diverged" if diverged else "")
                  + f": {_verdict(ok)}", flush=True)
        else:
            continue  # reported only
        if not ok:
            bad.append(name)
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(WORKLOADS))
    ap.add_argument("--data", default=None, type=Path,
                    help="the reference's data, rows, banks and chains "
                         "(tests/_paper_witness.py --out, and with "
                         "--chains 48)")
    ap.add_argument("--json", default=None, type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paper_runs: no CUDA device", file=sys.stderr)
        return 2
    only = args.only.split(",")
    unknown = set(only) - set(WORKLOADS)
    if unknown:
        raise SystemExit(f"unknown workloads {sorted(unknown)}")
    print(f"# {card_line()}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    runs = {"f1": run_f1, "fig5": run_fig5, "remark1": run_remark1,
            "table1": run_table1}
    ours, theirs = Rows(""), Rows("refdata:")
    data = load_data(args.data, dev) if args.data else None
    ref = (json.loads((args.data / "reference.json").read_text())
           if args.data else {})
    chains = (json.loads((args.data / "chains.json").read_text())
              if args.data else {})
    seconds, failed = {}, []
    for name in only:
        t0 = time.perf_counter()
        try:
            runs[name](dev, ours)
            if data is not None:
                runs[name](dev, theirs, data)
        except Exception:  # report it, run the other workloads
            traceback.print_exc()
            failed.append(name)
        seconds[name] = time.perf_counter() - t0
        print(f"# {name}: {seconds[name]:.1f} s", flush=True)
    bad = failed + (hold(theirs, ref, chains) if data is not None else [])
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": card_line(), "seconds": seconds,
            "port": ours.rows, "port_on_reference_data": theirs.rows,
            "reference": ref, "reference_chains": chains, "missed": bad},
            indent=1))
    if bad:
        print(f"# MISSED: {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
