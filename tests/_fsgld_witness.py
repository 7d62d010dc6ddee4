"""FSGLD at the transformer driver's defaults, in both packages, on the CPU.

qwen3-1.7b at full width (d_model 2048, 16/8 heads, d_ff 6144, vocab
151,936) cut to ``--layers`` layers. The JAX package's and the port's
local-SGLD fits and FSGLD rounds run at the train driver's defaults
(S = 4 token shards of 64 x 128, minibatch 8, h = 1e-5, a 'scalar' bank
from 20 fit steps stored in bf16, C = 1 chain, 5 rounds x 4 steps,
``reassign='permutation'``, the plain 'vmap' executor) from the same
theta0 (the reference's, converted) and shards (the port's, converted).
Only the transformer layers and the final norm are sampled; the
embedding and the head (2 x 311M parameters) stay at theta0, so that the
reference's fit, which keeps every step of its trace, fits in host
memory (one client at a time).

Prints per leaf the fitted precision of each client in both packages and
h * precision; per client the RMS of the first step's conducive move
(h/2) [lam_g (mu_g - theta0) - (lam_s / f_s) (mu_s - theta0)] against
the RMS of theta0 and of the step's noise sqrt(h); and ll/token at
theta0 and after sampling in both packages. The last line is one JSON
object of these numbers.

    PYTHONPATH=src python tests/_fsgld_witness.py [--layers 1]
                                                  [--step-size 1e-5]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.api as japi
import repro.models.model as JM
from repro.configs import get_config as jax_config
from repro.core import surrogate as jsur
from repro_torch import api as tapi
from repro_torch import tree as tu
from repro_torch.configs import get_config as torch_config
from repro_torch.convert import params_from_jax, tree_from_numpy
from repro_torch.data import token_shards
from repro_torch.models import model as TM

S, SHARD, SEQ, BATCH, FIT_STEPS, ROUNDS, STEPS = 4, 64, 128, 8, 20, 5, 4
FIXED = ("embed", "head")


def _split(tree):
    return ({k: v for k, v in tree.items() if k not in FIXED},
            {k: v for k, v in tree.items() if k in FIXED})


def _leaf_names(tree):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return ["/".join(str(getattr(k, "key", k)) for k in p) for p, _ in paths]


def jax_side(cfg, params, shards, h, seed):
    sub0, fixed = _split(params)
    ll = lambda p, b: JM.log_lik_fn({**fixed, **p}, cfg, b)  # noqa: E731
    probe = jax.tree.map(lambda d: d[0][:BATCH], shards)
    ll0 = float(ll(sub0, probe)) / probe["tokens"].size
    t0 = time.perf_counter()
    fits = []
    for s, k in enumerate(jax.random.split(jax.random.PRNGKey(seed), S)):
        b = japi.fit_bank_local_sgld(
            ll, jax.tree.map(lambda d: d[s:s + 1], shards), sub0, k,
            fit_steps=FIT_STEPS, minibatch=BATCH, step_size=h, kind="scalar")
        fits.append(jax.tree.map(np.asarray, (b.means, b.precs)))
        print(f"  jax: client {s} fitted, {time.perf_counter() - t0:.0f} s",
              flush=True)
    cat = lambda *xs: np.concatenate(xs)  # noqa: E731
    bank = jsur.make_bank(
        jax.tree.map(cat, *[f[0] for f in fits]),
        jax.tree.map(cat, *[f[1] for f in fits]), "scalar")
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
    print(f"  jax: fit and {ROUNDS} x {STEPS} steps, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    return jax.tree.map(np.asarray, bank), ll0, ll1


def torch_side(cfg, params, shards, h, seed):
    sub0, fixed = _split(params)
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
    print(f"  torch: fit and {ROUNDS} x {STEPS} steps, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    f32 = lambda t: t.float().numpy()  # noqa: E731
    return (tu.tree_map(f32, bank.means), tu.tree_map(f32, bank.precs),
            tu.tree_map(f32, bank.global_.mean),
            tu.tree_map(f32, bank.global_.prec)), ll0, ll1


def conducive_rms(means, precs, mean_g, prec_g, theta0, h):
    """Per client s: RMS over the sampled leaves of the first step's
    conducive move with f_s = 1/S (the permutation's visiting rate)."""
    out = []
    for s in range(S):
        sq, n = 0.0, 0
        for mu, lam, mg, lg, th in zip(*(jax.tree.leaves(x) for x in (
                means, precs, mean_g, prec_g, theta0))):
            th = np.asarray(th, np.float32)
            mv = (h / 2) * (lg * (mg.astype(np.float32) - th)
                            - S * lam[s] * (mu[s].astype(np.float32) - th))
            sq += float(np.sum(mv.astype(np.float64) ** 2))
            n += mv.size
        out.append(math.sqrt(sq / n))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--step-size", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    h = args.step_size
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
    sub0 = _split(np_params)[0]
    names = _leaf_names(sub0)
    P = sum(x.size for x in jax.tree.leaves(sub0))
    print(f"qwen3-1.7b at full width, {args.layers} layer(s); sampled "
          f"{len(names)} leaves, {P} parameters; h {h:g}", flush=True)

    jbank, jll0, jll1 = jax_side(jcfg, params, shards, h, args.seed + 2)
    del params, shards
    jb = (jbank.means, jbank.precs, jbank.global_.mean, jbank.global_.prec)
    tb, tll0, tll1 = torch_side(
        tcfg, params_from_jax(np_params, tcfg), tree_from_numpy(np_shards),
        h, args.seed + 2)

    rms0 = math.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64)))
                         for x in jax.tree.leaves(sub0)) / P)
    rows = {}
    for name, jl, tl in zip(names, jax.tree.leaves(jb[1]),
                            jax.tree.leaves(tb[1])):
        rows[name] = {"jax": [float(x) for x in jl],
                      "torch": [float(x) for x in tl],
                      "h_lam": [h * float(x) for x in jl]}
        print(f"  {name}: precision per client jax {np.round(jl, 1)} torch "
              f"{np.round(tl, 1)}; h*precision {np.round(h * jl, 3)}")
    jmv = conducive_rms(*jb, sub0, h)
    tmv = conducive_rms(*tb, sub0, h)
    print(f"  first step's conducive move, RMS per client: jax "
          f"{np.round(jmv, 5)} torch {np.round(tmv, 5)}; RMS of theta0 "
          f"{rms0:.5f}, of the step's noise {math.sqrt(h):.5f}")
    print(f"  ll/token: jax {jll0:.4f} -> {jll1:.4f}; torch {tll0:.4f} -> "
          f"{tll1:.4f}")
    print(json.dumps({"layers": args.layers, "h": h, "precisions": rows,
                      "conducive_rms": {"jax": jmv, "torch": tmv},
                      "theta0_rms": rms0,
                      "ll": {"jax": [jll0, jll1], "torch": [tll0, tll1]}}))


if __name__ == "__main__":
    main()
