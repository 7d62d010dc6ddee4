"""The port's packed rounds on the transformer against the JAX package:

* (e) one packed round with injected draws against a JAX loop of
  ``jax.grad(log_lik_fn)`` and the reference's packed kernel
  (``interpret=True``), a bf16 'scalar' bank, for qwen3 and for the MoE
  (whose router's aux loss enters the gradient);
* (f) packed == per_leaf bitwise at C = 3 on one generator, and a bank
  kept on the host (``Execution(bank_device='cpu')``) equal to one on the
  run's device on every executor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.model as JM
import repro_torch.models.model as TM
from _torch_train_common import _params, _tiny, fp32_activations  # noqa: F401
from repro.configs.base import SamplerConfig as JCfg
from repro.core import engine as jeng
from repro.core import sampler as jsam
from repro.core import surrogate as jsur
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig as TCfg
from repro_torch.convert import bank_from_numpy
from repro_torch.core import engine as teng
from repro_torch.core.sampler import ShardScheme
from repro_torch.data import token_shards
from repro_torch.kernels import ops as tops
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)


# ---------------------------------------------------------------------------
# (e) one packed round against the reference
# ---------------------------------------------------------------------------

def test_packed_round_matches_jax_loop(fp32_activations):
    """qwen3's smoke layout at d 64 (14 leaves), C = 2, T = 3, FSGLD with
    a 'scalar' bank stored in bf16 (the reference's own, carried across
    with its fp32-computed global mean), injected client ids, rows and
    seeds. fp32 activations (the gradients then agree to ~2e-6 relative);
    tolerance 1e-6 on the parameters: three steps of h = 1e-3 move them
    by ~1e-2, and the gradients' and normals' differences enter at
    h-scaled 1e-6 levels."""
    _packed_round_against_jax("qwen3-1.7b")


def test_moe_packed_round_matches_jax_loop(fp32_activations):
    """As ``test_packed_round_matches_jax_loop`` for phi3.5-moe's smoke
    layout at d 64 (4 experts, top-2; 2 groups of 8 tokens per chain and
    step, capacity 5): the router's aux loss enters every gradient."""
    _packed_round_against_jax("phi3.5-moe-42b-a6.6b")


def _packed_round_against_jax(arch):
    jcfg, tcfg = _tiny(arch)
    pj, pt = _params(jcfg, tcfg)
    rng = np.random.default_rng(6)
    S, n, m, C, T, h = 3, 6, 2, 2, 3, 1e-3
    toks = rng.integers(0, 128, (S, n, 9)).astype(np.int32)
    data = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    theta0 = jax.tree.map(np.asarray, pj)
    means = jax.tree.map(
        lambda t: (t + 0.01 * rng.standard_normal((S,) + t.shape)
                   ).astype(np.float32), theta0)
    precs = jax.tree.map(
        lambda t: rng.uniform(1.0, 50.0, (S,)).astype(np.float32), theta0)
    jbank = jsur.make_bank(jax.tree.map(jnp.asarray, means),
                           jax.tree.map(jnp.asarray, precs), "scalar",
                           store_dtype=jnp.bfloat16)
    sids = np.array([2, 0])
    idx = rng.integers(0, n, (T, C, m))
    L = len(jax.tree.leaves(theta0))
    seeds = rng.integers(0, 2**31 - 1, (T, C, L)).astype(np.uint32)
    kw = dict(method="fsgld", step_size=h, num_shards=S, local_updates=T,
              prior_precision=1.0, alpha=1.0, surrogate="scalar")

    jl = jops.make_packed_layout(pj)
    pb = jeng.pack_bank(jl, jbank)
    jscheme = jsam.ShardScheme((n,) * S, None)
    scale, f_s = jsam.chain_scales(JCfg(**kw), jscheme, jnp.asarray(sids), m)
    scalars = jops.packed_scalar_rows(
        jl, h=h, scale=scale, f_s=f_s, prior_prec=1.0, alpha=1.0,
        temperature=1.0, lam_g_leaf=pb["lam_g_leaf"],
        lam_s_leaf=pb["lam_s_leaf"][sids])
    gv = jax.jit(jax.vmap(jax.grad(lambda p, b: JM.log_lik_fn(p, jcfg, b))))
    mu_s = pb["means"][sids].reshape(-1, 128)
    thetas = jax.tree.map(lambda t: jnp.broadcast_to(t, (C,) + t.shape), pj)
    th_p = jl.pack(thetas)
    for t in range(T):
        batch = jax.tree.map(lambda d: jnp.asarray(d[sids[:, None], idx[t]]),
                             data)
        th_p = jops.packed_step(jl, th_p, jl.pack(gv(thetas, batch)),
                                jnp.asarray(seeds[t]), scalars,
                                variant="scalar", mu_g=pb["mu_g"],
                                mu_s=mu_s, interpret=True)
        thetas = jl.unpack(th_p)

    tl = tops.make_packed_layout(pt)
    round_fn = teng.make_packed_round_fn(
        lambda p, b: TM.log_lik_fn(p, tcfg, b), TCfg(**kw),
        ShardScheme((n,) * S, None), m, "scalar", tl)
    tbank = bank_from_numpy(
        jax.tree.map(np.asarray, jbank.means), precs, "scalar",
        global_mean=jax.tree.map(np.asarray, jbank.global_.mean),
        global_prec=jax.tree.map(np.asarray, jbank.global_.prec))
    draws = teng.RoundDraws(sids=torch.from_numpy(sids),
                            idx=torch.from_numpy(idx),
                            seeds=torch.from_numpy(seeds.astype(np.int64)))
    th = tl.pack(tu.tree_map(lambda x: x.expand((C,) + x.shape), pt))
    _, out = round_fn((th, tl.unpack(th)),  draws,
                      tu.tree_map(lambda a: torch.from_numpy(a).long(), data),
                      teng.pack_bank(tl, tbank))
    moved = 0.0
    for a, b, t0 in zip(tu.leaves(out), jax.tree.leaves(thetas),
                        jax.tree.leaves(theta0)):
        b = np.asarray(b)
        moved = max(moved, float(np.abs(b - t0).max()))
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0)
    assert moved > 1e-3  # the chains moved


# ---------------------------------------------------------------------------
# (f) packed == per_leaf
# ---------------------------------------------------------------------------

def test_packed_equals_per_leaf_bitwise_at_three_chains():
    """qwen3's smoke layout at d 64 (bf16 activations), C = 3, 2 rounds x
    2 steps, a prebuilt bf16 'scalar' bank, one generator: the final
    states of the packed and per-leaf executors are equal, bitwise."""
    cfg = _tiny("qwen3-1.7b")[1]
    theta0 = TM.init_params(cfg, torch.Generator().manual_seed(0))
    data = token_shards(torch.Generator().manual_seed(1), num_shards=3,
                        shard_size=4, seq_len=16, vocab_size=cfg.vocab_size)
    bank = api.fit_bank_local_sgld(
        lambda p, b: TM.log_lik_fn(p, cfg, b), data, theta0,
        torch.Generator().manual_seed(2), fit_steps=2, minibatch=2,
        step_size=1e-5, store_dtype=torch.bfloat16)
    out = {}
    for ex in ("packed", "per_leaf"):
        s = api.FSGLD(
            api.Posterior(lambda p, b: TM.log_lik_fn(p, cfg, b),
                          prior_precision=1.0), data, minibatch=2,
            step_size=1e-5,
            surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
            schedule=api.Schedule(rounds=2, local_steps=2, n_chains=3,
                                  reassign="permutation"),
            execution=api.Execution(device="cpu", executor=ex,
                                    collect=False, dtype=torch.bfloat16))
        out[ex] = s.sample(torch.Generator().manual_seed(3), theta0)
    moved = False
    for a, b, t0 in zip(tu.leaves(out["packed"]), tu.leaves(out["per_leaf"]),
                        tu.leaves(theta0)):
        assert a.shape == (3,) + t0.shape
        assert torch.equal(a, b)
        moved = moved or not torch.equal(a[0], t0)
    assert moved


def test_host_bank_runs_every_executor_like_a_device_bank():
    """``Execution(bank_device='cpu')`` keeps the means on the host and
    gathers the chains' clients' rows per round: the same final states,
    bitwise, as the bank on the run's device, on packed and per_leaf (and
    the plain vmap executor, which moves the bank to the device)."""
    cfg = _tiny("qwen3-1.7b")[1]
    theta0 = TM.init_params(cfg, torch.Generator().manual_seed(0))
    data = token_shards(torch.Generator().manual_seed(1), num_shards=2,
                        shard_size=4, seq_len=8, vocab_size=cfg.vocab_size)
    ll = lambda p, b: TM.log_lik_fn(p, cfg, b)  # noqa: E731
    bank = api.fit_bank_local_sgld(ll, data, theta0,
                                   torch.Generator().manual_seed(2),
                                   fit_steps=2, minibatch=2, step_size=1e-5)
    for ex in ("packed", "per_leaf", "vmap"):
        out = []
        for where in (None, "cpu"):
            s = api.FSGLD(
                api.Posterior(ll, prior_precision=1.0), data, minibatch=2,
                step_size=1e-5,
                surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
                schedule=api.Schedule(rounds=2, local_steps=1, n_chains=2,
                                      reassign="permutation"),
                execution=api.Execution(device="cpu", executor=ex,
                                        collect=False, bank_device=where))
            out.append(s.sample(torch.Generator().manual_seed(3), theta0))
        for a, b in zip(tu.leaves(out[0]), tu.leaves(out[1])):
            assert torch.equal(a, b)
