"""FSGLD at the transformer driver's defaults, in both packages, on the CPU.

qwen3-1.7b at full width (d_model 2048, 16/8 heads, d_ff 6144, vocab
151,936) cut to ``--layers`` layers. The JAX package's and the port's
local-SGLD fits and FSGLD rounds run at the train driver's defaults
(S = 4 token shards of 64 x 128, minibatch 8, h = 1e-5, a 'scalar' bank
from 20 fit steps stored in bf16, C = 1 chain, 5 rounds x 4 steps,
``reassign='permutation'``, the plain 'vmap' executor) from the same
theta0 (the reference's, converted) and shards (the port's, converted).
By default the embedding and the head (2 x 311M parameters) stay at
theta0 and the rest is sampled; ``--sample-all`` samples every leaf, as
the train driver does. The reference's fit runs through
``tests/_ref_streamed_fit.py`` (its local-SGLD steps one at a time with
running moments, one client at a time), the port's through
``repro_torch.api.fit_bank_local_sgld``, which streams by itself.

Prints per leaf the fitted precision of each client in both packages and
h * precision; per leaf group (embed, head, rest) and client the RMS of
the first step's conducive move (h/2) [lam_g (mu_g - theta0) - (lam_s /
f_s) (mu_s - theta0)] and of mu_s - theta0 as stored in the bf16 bank,
beside the RMS of theta0 and of the step's noise sqrt(h); ll/token at
theta0 and after sampling in both packages; the peak resident memory and
the wall time. The last line is one JSON object of these numbers.

    PYTHONPATH=src python tests/_fsgld_witness.py [--layers 1]
        [--step-size 1e-5] [--seed 0] [--sample-all]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import resource
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import repro.api as japi  # noqa: E402
import repro.models.model as JM  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import surrogate as jsur  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.convert import params_from_jax, tree_from_numpy  # noqa: E402
from repro_torch.data import token_shards  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from _ref_streamed_fit import streamed_scalar_fit  # noqa: E402

S, SHARD, SEQ, BATCH, FIT_STEPS, ROUNDS, STEPS = 4, 64, 128, 8, 20, 5, 4
GROUPS = ("embed", "head", "rest")


def _split(tree, fixed):
    return ({k: v for k, v in tree.items() if k not in fixed},
            {k: v for k, v in tree.items() if k in fixed})


def _leaf_names(tree):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return ["/".join(str(getattr(k, "key", k)) for k in p) for p, _ in paths]


def _group(name):
    top = name.split("/")[0]
    return top if top in ("embed", "head") else "rest"


def jax_side(cfg, params, shards, h, seed, fixed_names):
    sub0, fixed = _split(params, fixed_names)
    ll = lambda p, b: JM.log_lik_fn({**fixed, **p}, cfg, b)  # noqa: E731
    probe = jax.tree.map(lambda d: d[0][:BATCH], shards)
    ll0 = float(ll(sub0, probe)) / probe["tokens"].size
    t0 = time.perf_counter()
    means = jax.tree.map(
        lambda t: np.empty((S,) + t.shape, np.float32), sub0)
    precs = jax.tree.map(lambda t: np.empty((S,), np.float32), sub0)
    # the keys fit_bank_local_sgld hands its clients: split(key, S), and
    # each call here holds one client, so split(k, 1)[0]
    for s, k in enumerate(jax.random.split(jax.random.PRNGKey(seed), S)):
        mu, lam = streamed_scalar_fit(
            ll, jax.tree.map(lambda d: d[s], shards), sub0,
            jax.random.split(k, 1)[0], fit_steps=FIT_STEPS,
            minibatch=BATCH, step_size=h)
        for dst, m in zip(jax.tree.leaves(means), jax.tree.leaves(mu)):
            dst[s] = m
        for dst, m in zip(jax.tree.leaves(precs), jax.tree.leaves(lam)):
            dst[s] = m
        del mu
        print(f"  jax: client {s} fitted, {time.perf_counter() - t0:.0f} s",
              flush=True)
    # the global product in fp32 before the bf16 cast, as FSGLD's
    # Execution(dtype=bfloat16) casts the bank (a no-op cast then)
    bank = jsur.make_bank(means, precs, "scalar", store_dtype=jnp.bfloat16)
    del means
    s = japi.FSGLD(
        japi.Posterior(ll, prior_precision=1.0), shards, minibatch=BATCH,
        step_size=h, surrogate=japi.SurrogateSpec(kind="scalar", bank=bank),
        schedule=japi.Schedule(rounds=ROUNDS, local_steps=STEPS, n_chains=1,
                               reassign="permutation"),
        execution=japi.Execution(executor="vmap", collect=False,
                                 dtype=jnp.bfloat16))
    finals = s.sample(jax.random.PRNGKey(seed + 1), sub0)
    ll1 = float(ll(jax.tree.map(lambda t: t[0], finals), probe)) \
        / probe["tokens"].size
    del finals, s
    print(f"  jax: fit and {ROUNDS} x {STEPS} steps, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    bank = jax.tree.map(np.asarray, bank)
    return (bank.means, bank.precs, bank.global_.mean,
            bank.global_.prec), ll0, ll1


def torch_side(cfg, params, shards, h, seed, fixed_names):
    sub0, fixed = _split(params, fixed_names)
    ll = lambda p, b: TM.log_lik_fn({**fixed, **p}, cfg, b)  # noqa: E731
    probe = tu.tree_map(lambda d: d[0][:BATCH], shards)
    n_tok = probe["tokens"].numel()
    with torch.no_grad():
        ll0 = float(ll(sub0, probe)) / n_tok
    t0 = time.perf_counter()
    bank = tapi.fit_bank_local_sgld(
        ll, shards, sub0, torch.Generator().manual_seed(seed),
        fit_steps=FIT_STEPS, minibatch=BATCH, step_size=h, kind="scalar",
        store_dtype=torch.bfloat16)
    s = tapi.FSGLD(
        tapi.Posterior(ll, prior_precision=1.0), shards, minibatch=BATCH,
        step_size=h, surrogate=tapi.SurrogateSpec(kind="scalar", bank=bank),
        schedule=tapi.Schedule(rounds=ROUNDS, local_steps=STEPS, n_chains=1,
                               reassign="permutation"),
        execution=tapi.Execution(device="cpu", executor="vmap",
                                 collect=False, dtype=torch.bfloat16))
    finals = s.sample(torch.Generator().manual_seed(seed + 1), sub0)
    with torch.no_grad():
        ll1 = float(ll(tu.tree_map(lambda t: t[0], finals), probe)) / n_tok
    del finals, s
    print(f"  torch: fit and {ROUNDS} x {STEPS} steps, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    # bank.means are views of one packed stack: keep them as they are
    # stored (bf16), read in fp32 leaf by leaf below
    npy = lambda t: t.float().numpy() if t.ndim <= 1 else t  # noqa: E731
    return (bank.means, tu.tree_map(npy, bank.precs), bank.global_.mean,
            tu.tree_map(npy, bank.global_.prec)), ll0, ll1


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def group_rms(means, precs, mean_g, prec_g, theta0, names, h):
    """Per leaf group and client s: the RMS of the first step's conducive
    move with f_s = 1/S (the permutation's visiting rate), and the RMS of
    mu_s - theta0 as the bank stores mu_s."""
    groups = sorted({_group(n) for n in names}, key=GROUPS.index)
    sq = {g: np.zeros((2, S)) for g in groups}
    n = dict.fromkeys(groups, 0)
    for name, mu, lam, mg, lg, th in zip(names, *(
            jax.tree.leaves(x) for x in (means, precs, mean_g, prec_g,
                                         theta0))):
        g = _group(name)
        th = np.asarray(th, np.float32)
        pull_g = float(lg) * (_f32(mg) - th)
        n[g] += th.size
        for s in range(S):
            dev = _f32(mu[s]) - th
            mv = (h / 2) * (pull_g - S * float(lam[s]) * dev)
            sq[g][0, s] += float(np.sum(np.square(mv, dtype=np.float64)))
            sq[g][1, s] += float(np.sum(np.square(dev, dtype=np.float64)))
            del dev, mv
    return ({g: [math.sqrt(x / n[g]) for x in sq[g][0]] for g in groups},
            {g: [math.sqrt(x / n[g]) for x in sq[g][1]] for g in groups})


def main() -> None:
    wall = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--step-size", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample-all", action="store_true",
                    help="sample the embedding and the head too")
    args = ap.parse_args()
    h = args.step_size
    fixed_names = () if args.sample_all else ("embed", "head")
    jcfg = dataclasses.replace(jax_config("qwen3-1.7b"),
                               num_layers=args.layers)
    tcfg = dataclasses.replace(torch_config("qwen3-1.7b"),
                               num_layers=args.layers)
    params = JM.init_params(jcfg, jax.random.PRNGKey(args.seed))
    # the port's token_shards: the reference's draws all S x 64 x 129
    # Gumbel vectors over the vocabulary at once (20 GB here)
    np_shards = tu.tree_map(
        lambda t: t.numpy(), token_shards(
            torch.Generator().manual_seed(args.seed + 1), num_shards=S,
            shard_size=SHARD, seq_len=SEQ, vocab_size=jcfg.vocab_size))
    shards = jax.tree.map(jnp.asarray, np_shards)
    np_params = jax.tree.map(np.asarray, params)
    sub0 = _split(np_params, fixed_names)[0]
    names = _leaf_names(sub0)
    P = sum(x.size for x in jax.tree.leaves(sub0))
    print(f"{jcfg.name} at full width, {args.layers} layer(s); sampled "
          f"{len(names)} leaves, {P} parameters; h {h:g}", flush=True)

    jb, jll0, jll1 = jax_side(jcfg, params, shards, h, args.seed + 2,
                              fixed_names)
    del params, shards
    tb, tll0, tll1 = torch_side(
        tcfg, params_from_jax(np_params, tcfg), tree_from_numpy(np_shards),
        h, args.seed + 2, fixed_names)

    rms0 = math.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64)))
                         for x in jax.tree.leaves(sub0)) / P)
    rows = {}
    for name, jl, tl in zip(names, jax.tree.leaves(jb[1]),
                            jax.tree.leaves(tb[1])):
        jl, tl = np.asarray(jl, np.float64), np.asarray(tl, np.float64)
        rows[name] = {"jax": jl.tolist(), "torch": tl.tolist(),
                      "h_lam": {"jax": (h * jl).tolist(),
                                "torch": (h * tl).tolist()}}
        print(f"  {name}: precision per client jax {np.round(jl, 1)} torch "
              f"{np.round(tl, 1)}; h*precision jax {np.round(h * jl, 3)} "
              f"torch {np.round(h * tl, 3)}")
    jmv, jdev = group_rms(*jb, sub0, names, h)
    tmv, tdev = group_rms(*tb, sub0, names, h)
    for g in jmv:
        print(f"  {g}: first step's conducive move, RMS per client: jax "
              f"{np.round(jmv[g], 6)} torch {np.round(tmv[g], 6)}; RMS of "
              f"mu_s - theta0 (bf16 bank) jax {np.round(jdev[g], 6)} torch "
              f"{np.round(tdev[g], 6)}")
    print(f"  RMS of theta0 {rms0:.5f}, of the step's noise "
          f"{math.sqrt(h):.5f}")
    print(f"  ll/token: jax {jll0:.4f} -> {jll1:.4f}; torch {tll0:.4f} -> "
          f"{tll1:.4f}")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    seconds = time.perf_counter() - wall
    print(f"  peak resident memory {peak:.2f} GiB, wall {seconds:.0f} s")
    print(json.dumps({"layers": args.layers, "h": h, "seed": args.seed,
                      "sample_all": args.sample_all, "precisions": rows,
                      "conducive_rms": {"jax": jmv, "torch": tmv},
                      "mu_dev_rms": {"jax": jdev, "torch": tdev},
                      "theta0_rms": rms0,
                      "ll": {"jax": [jll0, jll1], "torch": [tll0, tll1]},
                      "peak_rss_gib": peak, "seconds": seconds}))


if __name__ == "__main__":
    main()
