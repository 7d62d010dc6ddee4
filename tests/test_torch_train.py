"""The port's transformer sampling path against the JAX package, at small
size (the smoke configs, 2 or 3 layers, d 256; some narrower still), on
the same numpy-made inputs:

* (a) the flash backward ``attention_scan_bwd`` (through the port's
  differentiable ``chunked_attention``) against ``jax.vjp`` of the
  reference's ``chunked_attention`` (its ``jax.custom_vjp``), fp32;
* (b) the differentiable flash entry under ``torch.func.vmap(grad(...))``
  equal to a loop over the chains;
* (d) the streaming surrogate fit: ``RunningMoments`` against
  ``fit_scalar_tree`` / ``fit_gaussian('diag')`` on one explicit trace,
  and ``fit_bank_local_sgld`` against a plain loop in its documented draw
  order whose trace goes through the reference's estimator and bank;
* (g) ``token_shards`` shapes and client skew.

The rest of the path: (c) the model's log-likelihood and gradient in
``test_torch_train_loglik_fp32.py`` and ``_bf16.py``, (e) and (f) the
packed rounds in ``test_torch_train_rounds.py``, (h) the train CLI in
``test_torch_train_cli.py``; their helpers in ``_torch_train_common.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import repro_torch.models.model as TM
from _torch_train_common import _params, _tiny
from repro.core import surrogate as jsur
from repro.models import layers as JL
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.core import engine as teng
from repro_torch.core.surrogate import RunningMoments
from repro_torch.data import token_shards
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)


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


FIT_STEPS, FIT_M, FIT_H = 6, 3, 1e-4


def _fit_problem(num_shards):
    """(log-lik, θ0, token shards of 6 rows) of the tiny qwen3."""
    jcfg, tcfg = _tiny("qwen3-1.7b")
    _, theta0 = _params(jcfg, tcfg)
    data = token_shards(torch.Generator().manual_seed(0),
                        num_shards=num_shards, shard_size=6, seq_len=8,
                        vocab_size=128)
    return (lambda p, b: TM.log_lik_fn(p, tcfg, b)), theta0, data


@pytest.fixture(scope="module")
def streamed_fit_traces():
    """The kept traces of a plain loop drawing in the order the streaming
    fit's docstring states (per client: per step the minibatch rows, then
    the normals leaf by leaf), made once for every storage dtype."""
    ll, theta0, data = _fit_problem(2)
    h, m, steps = FIT_H, FIT_M, FIT_STEPS
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
    return traces


@pytest.mark.parametrize("store", [None, torch.bfloat16])
def test_streaming_fit_equals_trace_fit_of_the_reference(
        store, monkeypatch, streamed_fit_traces):
    """``fit_bank_local_sgld`` streaming (its trace budget set to 0)
    against a plain loop drawing in the order its docstring states,
    whose kept trace goes through the reference's estimator and bank;
    tolerances as in ``_assert_bank_matches``."""
    monkeypatch.setattr(api, "FIT_TRACE_BYTES", 0)
    ll, theta0, data = _fit_problem(2)
    bank = api.fit_bank_local_sgld(
        ll, data, theta0, torch.Generator().manual_seed(5),
        fit_steps=FIT_STEPS, minibatch=FIT_M, step_size=FIT_H, kind="scalar",
        store_dtype=store)
    _assert_bank_matches(bank, _reference_bank(streamed_fit_traces, store),
                         store)


@pytest.fixture(scope="module")
def batched_fit_traces():
    """``sample_local_likelihood``'s traces of 3 clients, batched over the
    clients, made once for every storage dtype."""
    from repro_torch.core.federated import sample_local_likelihood
    ll, theta0, data = _fit_problem(3)
    tr = sample_local_likelihood(ll, data, theta0,
                                 torch.Generator().manual_seed(5),
                                 num_steps=FIT_STEPS, burn_in=3, thin=1,
                                 minibatch=FIT_M, step_size=FIT_H)
    return [tu.tree_map(lambda t: t[s], tr) for s in range(3)]


@pytest.mark.parametrize("store", [None, torch.bfloat16])
def test_small_fit_runs_all_clients_at_once(store, batched_fit_traces):
    """Under its trace budget ``fit_bank_local_sgld`` runs every client in
    one batch: the same bank as ``sample_local_likelihood`` (batched over
    the clients, on the same generator) through the reference's estimator
    and bank; tolerances as in ``_assert_bank_matches``."""
    ll, theta0, data = _fit_problem(3)
    bank = api.fit_bank_local_sgld(
        ll, data, theta0, torch.Generator().manual_seed(5),
        fit_steps=FIT_STEPS, kind="scalar", store_dtype=store,
        minibatch=FIT_M, step_size=FIT_H)
    _assert_bank_matches(bank, _reference_bank(batched_fit_traces, store),
                         store)


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
