"""The port's transformer sampling path against the JAX package.

Same numpy-made inputs on both sides, at small size (the smoke configs of
qwen3-1.7b, h2o-danube-1.8b, phi3.5-moe, grok-1, recurrentgemma-2b and
rwkv6-7b: 2 or 3 layers, d 256; some narrower still):

* (a) the flash backward ``attention_scan_bwd`` (through the port's
  differentiable ``chunked_attention``) against ``jax.vjp`` of the
  reference's ``chunked_attention`` (its ``jax.custom_vjp``), fp32;
* (b) the differentiable flash entry under ``torch.func.vmap(grad(...))``
  equal to a loop over the chains;
* (c) ``forward`` / ``chunked_log_lik`` / ``log_lik_fn`` and their
  gradients against ``jax.grad`` of the reference's, on converted params,
  in fp32 activations (both packages' ``ACT_DTYPE`` patched) and in the
  bf16 they run in;
* (d) the streaming surrogate fit: ``RunningMoments`` against
  ``fit_scalar_tree`` / ``fit_gaussian('diag')`` on one explicit trace,
  and ``fit_bank_local_sgld`` against a plain loop in its documented draw
  order whose trace goes through the reference's estimator and bank;
* (e) one packed round with injected draws against a JAX loop of
  ``jax.grad(log_lik_fn)`` and the reference's packed kernel
  (``interpret=True``), a bf16 'scalar' bank, for qwen3 and for the MoE
  (whose router's aux loss enters the gradient);
* (f) packed == per_leaf bitwise at C = 3 on one generator;
* (g) ``token_shards`` shapes and client skew;
* (h) the train CLI on the CPU, and its refused flags.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import repro.models.model as JM
import repro_torch.models.model as TM
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import SamplerConfig as JCfg
from repro.core import engine as jeng
from repro.core import sampler as jsam
from repro.core import surrogate as jsur
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.configs.base import SamplerConfig as TCfg
from repro_torch.convert import bank_from_numpy, params_from_jax
from repro_torch.core import engine as teng
from repro_torch.core.sampler import ShardScheme
from repro_torch.core.surrogate import RunningMoments
from repro_torch.data import token_shards
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL

ARCHS = ("qwen3-1.7b", "h2o-danube-1.8b", "phi3.5-moe-42b-a6.6b",
         "grok-1-314b", "recurrentgemma-2b", "rwkv6-7b")


def _tiny(arch):
    """Both packages' smoke config of ``arch``, narrower still (d 64, vocab
    128), for the tests that run the reference's interpret-mode kernel."""
    kw = dict(d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=128)
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(torch_smoke(arch), **kw))


@pytest.fixture
def fp32_activations(monkeypatch):
    """Both packages' models in fp32 activations: the point is then the
    algorithm, not where each rounds to bf16. Besides the module dtype,
    the casts and the decode caches take the activation dtype as a
    default argument (bound when defined), so those are patched too."""
    monkeypatch.setattr(JM, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(JM._cast_floating, "__defaults__", (jnp.float32,))
    monkeypatch.setattr(JM.init_cache, "__defaults__", (jnp.float32,))
    monkeypatch.setattr(TM, "ACT_DTYPE", torch.float32)
    monkeypatch.setattr(TM._cast_floating, "__defaults__", (torch.float32,))
    monkeypatch.setattr(TM.init_cache, "__defaults__", (torch.float32, None))


def _params(jcfg, tcfg, seed=0):
    pj = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), tcfg)


def _batch(vocab, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    toks = toks.astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


# ---------------------------------------------------------------------------
# (a) the attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (4, 1)])
def test_attention_backward_matches_jax_vjp(causal, window, H, Hkv):
    """fp32, Sq = 100 over key blocks of 32 (a ragged last block), GQA.
    Tolerance 1e-5 of the largest gradient: the same fp32 arithmetic,
    summed in another order."""
    rng = np.random.default_rng(H * 10 + Hkv)
    B, S, hd, bk = 2, 100, 16, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    dout = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jpos = jnp.asarray(pos)
    out_j, vjp = jax.vjp(lambda a, b, c: JL.chunked_attention(
        a, b, c, q_positions=jpos, kv_positions=jpos, causal=causal,
        window=window, block_k=bk), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tpos = torch.from_numpy(pos.copy()).long()
    out_t = TL.chunked_attention(tq, tk, tv, q_positions=tpos,
                                 kv_positions=tpos, causal=causal,
                                 window=window, block_k=bk)
    got = torch.autograd.grad(out_t, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-6, rtol=1e-5)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-5 * np.abs(w).max(), rtol=0)


def test_lse_statistics_equal_the_scan_rows():
    """The statistics entry on the CPU: the output of ``flash_attention``
    and lse = m + log(l) of the plain scan's rows."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 70, 4, 32), (2, 70, 2, 32), (2, 70, 2, 32)))
    out, lse = tfa.flash_attention_lse(q, k, v, window=20)
    assert torch.equal(out, tfa.flash_attention(q, k, v, window=20))
    pos = torch.arange(70).expand(2, 70)
    _, m, l = tfa.attention_scan(q, k, v, pos, pos, window=20, stats=True)
    assert lse.shape == (2, 4, 70)
    torch.testing.assert_close(lse, m + torch.log(l), atol=0, rtol=0)


def test_backward_from_rounded_log_sum_exp_statistics():
    """The kernel hands the backward each row's log-sum-exp (m = lse,
    l = 1), from approximate exp2/log2. Statistics perturbed by 1e-6 give
    the gradients of the exact (m, l) within 1e-5 of the largest, and a
    causal query that sees one key keeps its exact zero dq (its
    probability is renormalised to 1)."""
    rng = np.random.default_rng(7)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((2, 40, 4, 16), (2, 40, 2, 16),
                               (2, 40, 2, 16), (2, 40, 4, 16)))
    pos = torch.arange(40).expand(2, 40)
    _, m, l = tfa.attention_scan(q, k, v, pos, pos, stats=True)
    want = tfa.attention_scan_bwd(q, k, v, pos, pos, m, l, dout)
    lse = m + torch.log(l) + 1e-6 * torch.randn(m.shape)
    got = tfa.attention_scan_bwd(q, k, v, pos, pos, lse,
                                 torch.ones_like(lse), dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    assert torch.equal(got[0][:, 0], torch.zeros_like(got[0][:, 0]))


# ---------------------------------------------------------------------------
# (b) the vmap rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 9])
def test_differentiable_flash_under_vmap_grad_equals_a_chain_loop(dtype,
                                                                  window):
    """C = 3 chains through ``torch.func.vmap(grad(...))`` (the rule folds
    the chain axis into the batch): equal to the same gradient taken
    chain by chain (fp32 within 1e-6; bf16 within one
    bf16 ulp of each gradient's largest entry: the folded batch only
    reorders the same fp32 sums)."""
    rng = np.random.default_rng(2)
    C, B, S, H, K, hd = 3, 2, 40, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((C, B, S, n, hd))
                                .astype(np.float32)).to(dtype)
               for n in (H, K, K))
    w = torch.from_numpy(rng.standard_normal((B, S, H, hd))
                         .astype(np.float32))

    def loss(q, k, v):
        out = tfa.flash_attention_diff(q, k, v, window=window)
        return (out.float() * w).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    for c in range(C):
        want = grad(loss, argnums=(0, 1, 2))(q[c], k[c], v[c])
        for g, ww in zip(got, want):
            tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
            torch.testing.assert_close(
                g[c].float(), ww.float(), rtol=0,
                atol=tol * float(ww.float().abs().max()))


def test_chunked_attention_positions_under_vmap():
    """Explicit positions (unbatched) next to batched q, k, v."""
    rng = np.random.default_rng(3)
    C, B, S, hd = 2, 1, 33, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((C, B, S, 2, hd))
                                .astype(np.float32)) for _ in range(3))
    pos = torch.arange(S).expand(B, S)

    def loss(q, k, v):
        return TL.chunked_attention(q, k, v, q_positions=pos,
                                    kv_positions=pos, block_k=8).sum()

    got = vmap(grad(loss))(q, k, v)
    for c in range(C):
        torch.testing.assert_close(got[c], grad(loss)(q[c], k[c], v[c]),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the model's log-likelihood and its gradient
# ---------------------------------------------------------------------------

def _jax_value_and_grad(jcfg, pj, bj):
    return jax.jit(jax.value_and_grad(lambda p: JM.log_lik_fn(p, jcfg, bj)))(
        pj)


@pytest.mark.parametrize("arch", ARCHS)
def test_log_lik_and_grad_match_jax_fp32(arch, fp32_activations):
    """fp32 activations: the hidden states and the MoE aux loss within 1e-5
    of the largest, the log-likelihood within 1e-6 relative, every
    gradient leaf within 1e-5 relative norm (measured: 2e-6 dense, up to
    3.4e-6 for the MoE, RG-LRU and RWKV-6 configs; no MoE route differs
    in fp32 at these inputs, capacity drops included)."""
    jcfg, tcfg = jax_smoke(arch), torch_smoke(arch)
    pj, pt = _params(jcfg, tcfg)
    bj, bt = _batch(jcfg.vocab_size, 2, 100)
    hj, auxj = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(pj, bj["tokens"])
    ht, auxt = TM.forward(pt, tcfg, bt["tokens"])
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=1e-5 * float(np.abs(hj).max()))
    assert abs(float(auxt) - float(auxj)) <= 1e-5 * abs(float(auxj))
    llj = JM.chunked_log_lik(hj, pj["head"], bj["labels"], chunk=32)
    llt = TM.chunked_log_lik(ht, pt["head"], bt["labels"], chunk=32)
    assert abs(float(llt) / float(llj) - 1) < 1e-6
    lj, gj = _jax_value_and_grad(jcfg, pj, bj)
    gt = grad(lambda p: TM.log_lik_fn(p, tcfg, bt))(pt)
    assert abs(float(TM.log_lik_fn(pt, tcfg, bt)) / float(lj) - 1) < 1e-6
    for a, b in zip(jax.tree.leaves(gj), tu.leaves(gt)):
        assert _rel(a, b.numpy()) < 1e-5


def _no_flip(cfg):
    """The MoE with as many experts as it routes to: every token goes to
    every expert, so no route can flip between the packages."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=cfg.moe.top_k))


@pytest.mark.parametrize("arch", ARCHS)
def test_log_lik_and_grad_match_jax_bf16(arch):
    """The bf16 activations both run in: the two packages round to bf16 at
    other points, so the log-likelihood is held within 1e-3 relative
    (measured: 7e-5 qwen3, 1.0e-4 danube, up to 2.1e-4 for the new
    families) and each gradient leaf within 5e-2 relative norm
    (measured: 0.7e-2 to 3.1e-2 over the leaves).

    MoE: a bf16 rounding can flip a token's route near a tie, which
    moves the gradient by more than rounding does (up to 6.7e-2 on a
    leaf). As the reference's ``test_moe_parity_majority`` does, the
    hidden states are held per position: at least 90% of them within
    5e-2 of max|h| (measured 99% phi3.5, 99.5% grok); the gradient is
    held on the same model with E = top_k experts, where no route can
    flip (measured: up to 1.6e-2)."""
    jcfg, tcfg = jax_smoke(arch), torch_smoke(arch)
    pj, pt = _params(jcfg, tcfg)
    bj, bt = _batch(jcfg.vocab_size, 2, 100)
    lj, gj = _jax_value_and_grad(jcfg, pj, bj)
    lt = TM.log_lik_fn(pt, tcfg, bt)
    assert abs(float(lt) / float(lj) - 1) < 1e-3
    if jcfg.moe is not None:
        hj, _ = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(pj,
                                                            bj["tokens"])
        hj = np.asarray(hj.astype(jnp.float32))
        ht, _ = TM.forward(pt, tcfg, bt["tokens"])
        err = np.abs(ht.float().numpy() - hj).max(-1) / np.abs(hj).max()
        assert (err < 5e-2).mean() >= 0.9
        jcfg, tcfg = _no_flip(jcfg), _no_flip(tcfg)
        pj, pt = _params(jcfg, tcfg)
        _, gj = _jax_value_and_grad(jcfg, pj, bj)
    gt = grad(lambda p: TM.log_lik_fn(p, tcfg, bt))(pt)
    for a, b in zip(jax.tree.leaves(gj), tu.leaves(gt)):
        assert b.dtype == torch.float32
        assert _rel(a, b.numpy()) < 5e-2


def test_other_layer_kinds_name_their_item():
    """Every layer kind runs (ROADMAP item 15 is done); an 'xattn' layer in
    a family without an encoder stream is refused, naming the family."""
    cfg = dataclasses.replace(torch_smoke("qwen3-1.7b"),
                              layer_pattern=("xattn",))
    with pytest.raises(ValueError, match="vlm or audio family"):
        TM.forward({}, cfg, torch.zeros(1, 4, dtype=torch.long))


# ---------------------------------------------------------------------------
# (d) the streaming fit
# ---------------------------------------------------------------------------

def test_running_moments_match_the_reference_estimators():
    """One explicit trace (10 samples; a leaf whose spread is 1e-3 of its
    mean): means within 1e-6 of the largest (a few float32 ulps: another
    summation order), precisions within 1e-6 relative (Welford on
    deviations from the first sample keeps them that close)."""
    rng = np.random.default_rng(4)
    tr = {"a": (0.3 + 0.01 * rng.standard_normal((10, 50, 3))),
          "b": (rng.standard_normal(7) + 1e-3 * rng.standard_normal((10, 7)))}
    tr = {n: v.astype(np.float32) for n, v in tr.items()}
    rm = RunningMoments("scalar")
    for i in range(10):
        rm.update({n: torch.from_numpy(v[i]) for n, v in tr.items()})
    mu, prec = rm.finish(jitter=1e-8)
    jmu, jprec = jsur.fit_scalar_tree(jax.tree.map(jnp.asarray, tr),
                                      jitter=1e-8)
    for n in tr:
        np.testing.assert_allclose(mu[n].numpy(), np.asarray(jmu[n]),
                                   rtol=0, atol=1e-6 * np.abs(tr[n]).max())
        assert abs(float(prec[n]) / float(jprec[n]) - 1) < 1e-6
    rd = RunningMoments("diag")
    for i in range(10):
        rd.update(torch.from_numpy(tr["b"][i]))
    mu, prec = rd.finish(jitter=1e-8)
    jmu, jprec = jsur.fit_gaussian(jnp.asarray(tr["b"]), "diag",
                                   jitter=1e-8)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0,
                               atol=1e-6 * np.abs(tr["b"]).max())
    np.testing.assert_allclose(prec.numpy(), np.asarray(jprec), rtol=1e-6)


def _reference_bank(traces, store):
    """The reference's ``fit_scalar_tree`` and ``make_bank`` (+ ``astype``)
    over one kept trace per client."""
    fits = [jsur.fit_scalar_tree(jax.tree.map(
        lambda x: jnp.asarray(x.numpy()), tr), jitter=1e-8) for tr in traces]
    jbank = jsur.make_bank(jax.tree.map(lambda *xs: jnp.stack(xs),
                                        *[f[0] for f in fits]),
                           jax.tree.map(lambda *xs: jnp.stack(xs),
                                        *[f[1] for f in fits]), "scalar")
    return jbank if store is None else jbank.astype(jnp.bfloat16)


def _assert_bank_matches(bank, jbank, store):
    """Means and global mean within 1e-6 of the largest (bf16 storage:
    one bf16 ulp), precisions within 1e-6 relative."""
    tol = 2.0 ** -8 if store is not None else 1e-6
    for got, want in ((bank.means, jbank.means),
                      (bank.global_.mean, jbank.global_.mean)):
        for a, b in zip(tu.leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b.astype(jnp.float32))
            assert a.dtype == (store or torch.float32)
            np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                       atol=tol * np.abs(b).max())
    for a, b in zip(tu.leaves(bank.precs), jax.tree.leaves(jbank.precs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("store", [None, torch.bfloat16])
def test_streaming_fit_equals_trace_fit_of_the_reference(store,
                                                         monkeypatch):
    """``fit_bank_local_sgld`` streaming (its trace budget set to 0)
    against a plain loop drawing in the order its docstring states (per
    client: per step the minibatch rows, then the normals leaf by leaf),
    whose kept trace goes through the reference's estimator and bank;
    tolerances as in ``_assert_bank_matches``."""
    monkeypatch.setattr(api, "FIT_TRACE_BYTES", 0)
    jcfg, tcfg = _tiny("qwen3-1.7b")
    _, theta0 = _params(jcfg, tcfg)
    data = token_shards(torch.Generator().manual_seed(0), num_shards=2,
                        shard_size=6, seq_len=8, vocab_size=128)
    ll = lambda p, b: TM.log_lik_fn(p, tcfg, b)  # noqa: E731
    h, m, steps = 1e-4, 3, 6
    bank = api.fit_bank_local_sgld(
        ll, data, theta0, torch.Generator().manual_seed(5), fit_steps=steps,
        minibatch=m, step_size=h, kind="scalar", store_dtype=store)
    g = torch.Generator().manual_seed(5)
    traces = []
    for s in range(2):
        th, kept = theta0, []
        for t in range(steps):
            idx = torch.randint(0, 6, (m,), generator=g)
            gr = grad(ll)(th, tu.tree_map(lambda d: d[s][idx], data))
            th = tu.tree_map(lambda a, b: torch.add(a, b, alpha=h / 2 * 6 / m),
                             th, gr)
            th = tu.tree_map(lambda a: torch.add(a, torch.randn(
                a.shape, generator=g), alpha=h ** 0.5), th)
            if t >= steps // 2:
                kept.append(th)
        traces.append(tu.tree_map(lambda *xs: torch.stack(xs), *kept))
    _assert_bank_matches(bank, _reference_bank(traces, store), store)


@pytest.mark.parametrize("store", [None, torch.bfloat16])
def test_small_fit_runs_all_clients_at_once(store):
    """Under its trace budget ``fit_bank_local_sgld`` runs every client in
    one batch: the same bank as ``sample_local_likelihood`` (batched over
    the clients, on the same generator) through the reference's estimator
    and bank; tolerances as in ``_assert_bank_matches``."""
    from repro_torch.core.federated import sample_local_likelihood
    jcfg, tcfg = _tiny("qwen3-1.7b")
    _, theta0 = _params(jcfg, tcfg)
    data = token_shards(torch.Generator().manual_seed(0), num_shards=3,
                        shard_size=6, seq_len=8, vocab_size=128)
    ll = lambda p, b: TM.log_lik_fn(p, tcfg, b)  # noqa: E731
    kw = dict(minibatch=3, step_size=1e-4)
    bank = api.fit_bank_local_sgld(
        ll, data, theta0, torch.Generator().manual_seed(5), fit_steps=6,
        kind="scalar", store_dtype=store, **kw)
    tr = sample_local_likelihood(ll, data, theta0,
                                 torch.Generator().manual_seed(5),
                                 num_steps=6, burn_in=3, thin=1, **kw)
    traces = [tu.tree_map(lambda t: t[s], tr) for s in range(3)]
    _assert_bank_matches(bank, _reference_bank(traces, store), store)


def test_fit_stack_is_the_packed_bank_buffer(monkeypatch):
    """The streaming fit (its trace budget set to 0) writes its means into
    the packed layout: packing the bank reuses that buffer (no copy), at
    the storage dtype."""
    monkeypatch.setattr(api, "FIT_TRACE_BYTES", 0)
    jcfg, tcfg = _tiny("qwen3-1.7b")
    _, theta0 = _params(jcfg, tcfg)
    data = token_shards(torch.Generator().manual_seed(0), num_shards=2,
                        shard_size=4, seq_len=8, vocab_size=128)
    bank = api.fit_bank_local_sgld(
        lambda p, b: TM.log_lik_fn(p, tcfg, b), data, theta0,
        torch.Generator().manual_seed(1), fit_steps=2, minibatch=2,
        step_size=1e-4, store_dtype=torch.bfloat16)
    layout = tops.make_packed_layout(theta0)
    base = layout.base_of(bank.means)
    assert base is not None and base.dtype == torch.bfloat16
    pb = teng.pack_bank(layout, bank)
    assert pb["means"].data_ptr() == base.data_ptr()
    assert pb["mu_g"].dtype == torch.float32
    assert layout.base_of(tu.tree_map(torch.clone, bank.means)) is None


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


# ---------------------------------------------------------------------------
# (g) token shards
# ---------------------------------------------------------------------------

def test_token_shards_shapes_and_client_skew():
    """As the reference's ``test_token_shards_heterogeneous``: shapes,
    labels the next-token shift, and per-client unigrams that differ
    (cosine of two clients' histograms below 0.9 at alpha 0.05)."""
    d = token_shards(torch.Generator().manual_seed(0), num_shards=4,
                     shard_size=32, seq_len=16, vocab_size=64, alpha=0.05)
    assert d["tokens"].shape == d["labels"].shape == (4, 32, 16)
    assert int(d["tokens"].min()) >= 0 and int(d["tokens"].max()) < 64
    again = token_shards(torch.Generator().manual_seed(0), num_shards=4,
                         shard_size=32, seq_len=16, vocab_size=64,
                         alpha=0.05)
    assert torch.equal(d["tokens"], again["tokens"])
    hists = [np.bincount(d["tokens"][s].ravel().numpy(), minlength=64)
             for s in range(4)]
    cos = np.dot(hists[0], hists[1]) / (np.linalg.norm(hists[0])
                                        * np.linalg.norm(hists[1]))
    assert cos < 0.9, cos


# ---------------------------------------------------------------------------
# (h) the train CLI
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--smoke", "--rounds", "1", "--local-updates",
         "2", "--fit-steps", "2", "--num-shards", "2", "--shard-size", "4",
         "--batch", "2", "--seq", "16"]


@pytest.mark.parametrize("extra", [[], ["--chains", "2", "--no-packed",
                                         "--use-kernel"]])
def test_train_cli_on_the_cpu_prints_finite_ll_per_chain(extra, capsys):
    assert ttrain.main(SMALL + extra) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("chain ")]
    chains = 2 if extra else 1
    assert len(lines) == chains
    for ln in lines:
        assert np.isfinite(float(ln.split("ll/token=")[1]))
    assert "params: 1.44M" in out and "surrogates fitted" in out
    assert f"executor={'per_leaf' if extra else 'auto'}" in out


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "grok-1-314b",
                                  "recurrentgemma-2b", "rwkv6-7b"])
def test_train_cli_samples_every_decoder_family(arch, capsys):
    """The MoE, hybrid and ssm smoke configs through the driver's fit and
    the packed executor: finite ll per chain."""
    assert ttrain.main(SMALL + ["--arch", arch, "--chains", "2",
                                "--use-kernel"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("chain ")]
    assert len(lines) == 2 and f"arch={arch}" in out
    for ln in lines:
        assert np.isfinite(float(ln.split("ll/token=")[1]))


@pytest.mark.parametrize("flag,match", [(["--multi-pod"], "even world")])
def test_train_cli_refuses_flags_naming_their_item(flag, match):
    """Every flag of the reference's driver is ported; ``--multi-pod``
    outside torchrun (one rank) is refused before any process group
    starts: one rank is not two pods (its run on two ranks:
    tests/test_torch_mesh.py)."""
    with pytest.raises(ValueError, match=match):
        ttrain.main(SMALL + flag)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("flag,match", [
    (["--snapshot-every", "2"], "need --snapshot-dir"),
    (["--resume"], "need --snapshot-dir"),
    (["--draw-bank", "d", "--snapshot-every", "2", "--snapshot-dir", "s"],
     "pick one"),
    (["--draw-bank", "d", "--resume", "--snapshot-dir", "s"], "pick one")])
def test_train_cli_refuses_the_reference_combinations(flag, match):
    """The reference driver's combination refusals of the fault-tolerance
    flags (which themselves run: ``tests/test_torch_resume.py``)."""
    with pytest.raises(SystemExit, match=match):
        ttrain.parse_args(SMALL + flag)


def test_train_cli_runs_with_bank_every_one_the_reference_default():
    assert ttrain.parse_args(SMALL).bank_every == 1
    assert ttrain.main(SMALL + ["--bank-every", "1"]) == 0


def test_train_cli_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(SMALL[2:])


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
