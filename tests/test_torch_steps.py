"""The production step functions (``repro_torch.launch.steps``) against the
JAX package's (``repro.launch.steps``), on the CPU at qwen3's smoke
layout narrowed to d 64 and one layer (14 leaves).

* ``train_step`` at temperature 0 (no noise on either side), FSGLD with
  'scalar' surrogates, in fp32 activations: parameters within 1e-5 +
  1e-5 |x|, the log-likelihood within 1e-5 of its size;
* at temperature 1 the noise part, theta'_1 - theta'_0 = sqrt(h) xi,
  against the reference kernel's counter-hash normals of the same
  per-leaf seeds, to 1e-6;
* ``bank_round_state`` against the reference's from the same bank,
  bitwise;
* ``prefill_step`` / ``serve_step`` tokens (bf16 activations) equal to
  the reference's wherever the reference's top-2 logit gap exceeds the
  bf16 tolerance, 2^-5 (1 + |top logit|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
from repro.configs import SamplerConfig as JSampler
from repro.configs import get_smoke_config as jax_smoke
from repro.core import make_bank as jmake_bank
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro_torch import tree as tu
from repro_torch.configs import SamplerConfig
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core.surrogate import make_bank
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

ARCH = "qwen3-1.7b"
H = 1e-2


def _cfgs():
    kw = dict(d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=128, num_layers=1)
    return (dataclasses.replace(jax_smoke(ARCH), **kw),
            dataclasses.replace(torch_smoke(ARCH), **kw))


@pytest.fixture
def fp32_activations(monkeypatch):
    """Both models in fp32 activations (the casts and the caches take the
    activation dtype as a bound default, so those are patched too)."""
    monkeypatch.setattr(JM, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(JM._cast_floating, "__defaults__", (jnp.float32,))
    monkeypatch.setattr(JM.init_cache, "__defaults__", (jnp.float32,))
    monkeypatch.setattr(TM, "ACT_DTYPE", torch.float32)
    monkeypatch.setattr(TM._cast_floating, "__defaults__", (torch.float32,))
    monkeypatch.setattr(TM.init_cache, "__defaults__", (torch.float32, None))


def _params(jcfg, tcfg, seed=0):
    pj = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(seed))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), tcfg)


def _batch(vocab, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    toks = toks.astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()})


def _surr(pj, seed=1):
    """The same 'scalar' operand on both sides: bf16 means near the
    parameters, per-leaf precisions."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(pj)
    mg = [np.asarray(l) + 0.05 * rng.standard_normal(l.shape) for l in leaves]
    ms = [np.asarray(l) + 0.05 * rng.standard_normal(l.shape) for l in leaves]
    lg = [np.float32(0.3 + 0.01 * i) for i in range(len(leaves))]
    ls = [np.float32(0.2 + 0.01 * i) for i in range(len(leaves))]

    def jt(xs, dt):
        return jax.tree.unflatten(treedef, [jnp.asarray(x, dt) for x in xs])
    jsurr = {"mu_g": jt(mg, jnp.bfloat16), "mu_s": jt(ms, jnp.bfloat16),
             "lam_g": jt(lg, jnp.float32), "lam_s": jt(ls, jnp.float32)}

    def tleaves(xs, dt):
        return [torch.tensor(np.asarray(x, np.float32)).to(dt) for x in xs]

    ttree = tu.flatten(params_from_jax(jax.tree.map(np.asarray, pj),
                                       _cfgs()[1]))[1]
    tsurr = {"mu_g": tu.unflatten(ttree, tleaves(mg, torch.bfloat16)),
             "mu_s": tu.unflatten(ttree, tleaves(ms, torch.bfloat16)),
             "lam_g": tu.unflatten(ttree, tleaves(lg, torch.float32)),
             "lam_s": tu.unflatten(ttree, tleaves(ls, torch.float32))}
    return jsurr, tsurr


def _steps(temperature):
    kw = dict(method="fsgld", step_size=H, num_shards=4, alpha=0.7,
              prior_precision=0.5, temperature=temperature)
    js = jax.jit(jsteps.make_train_step(_cfgs()[0], JSampler(**kw),
                                        scale=3.0, f_s=0.25))
    ts = tsteps.make_train_step(_cfgs()[1], SamplerConfig(**kw), scale=3.0,
                                f_s=0.25)
    return js, ts


def test_train_step_without_noise_matches_the_reference(fp32_activations):
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg.vocab_size, 2, 16)
    jsurr, tsurr = _surr(pj)
    js, ts = _steps(0.0)
    jnew, jm = js(pj, jsurr, jb, jax.random.PRNGKey(0))
    seeds = torch.arange(len(tu.leaves(pt)), dtype=torch.int64)
    tnew, tm = ts(pt, tsurr, tb, seeds)
    np.testing.assert_allclose(float(tm["log_lik"]), float(jm["log_lik"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["ll_per_token"]),
                               float(jm["ll_per_token"]), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jnew), tcfg)
    for a, b in zip(tu.leaves(tnew), tu.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # the step moved every leaf it should (a wrong drift would show)
    moved = [not torch.equal(a, b) for a, b in zip(tu.leaves(tnew),
                                                   tu.leaves(pt))]
    assert all(moved)


def test_train_step_noise_is_the_reference_kernels_counter_hash():
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg, tcfg)
    _, tb = _batch(jcfg.vocab_size, 2, 8)
    _, tsurr = _surr(pj)
    seeds = torch.tensor([11 + 7 * i for i in range(len(tu.leaves(pt)))])
    _, ts0 = _steps(0.0)
    _, ts1 = _steps(1.0)
    a, _ = ts0(pt, tsurr, tb, seeds)
    b, _ = ts1(pt, tsurr, tb, seeds)
    for i, (x0, x1) in enumerate(zip(tu.leaves(a), tu.leaves(b))):
        xi = np.asarray(jref.gaussian_noise(
            jnp.uint32(int(seeds[i])), jnp.arange(x0.numel(),
                                                  dtype=jnp.uint32)))
        # the noise part sqrt(h tau) xi of each element
        got = (x1 - x0).reshape(-1).numpy()
        np.testing.assert_allclose(got, np.sqrt(H) * xi, atol=1e-6, rtol=0)


def test_train_step_draws_its_seeds_from_a_generator():
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg, tcfg)
    _, tb = _batch(jcfg.vocab_size, 2, 8)
    _, tsurr = _surr(pj)
    _, ts = _steps(1.0)
    a, _ = ts(pt, tsurr, tb, torch.Generator().manual_seed(3))
    from repro_torch.kernels.ops import chain_leaf_seeds
    seeds = chain_leaf_seeds(torch.Generator().manual_seed(3),
                             len(tu.leaves(pt)))
    b, _ = ts(pt, tsurr, tb, seeds)
    for x, y in zip(tu.leaves(a), tu.leaves(b)):
        assert torch.equal(x, y)


def test_bank_round_state_matches_the_reference():
    rng = np.random.default_rng(4)
    S = 3
    shapes = {"a": (4, 3), "b": (5,)}
    means = {k: rng.standard_normal((S,) + s).astype(np.float32)
             for k, s in shapes.items()}
    precs = {k: rng.uniform(0.5, 2.0, S).astype(np.float32) for k in shapes}
    jb = jmake_bank(jax.tree.map(jnp.asarray, means),
                    jax.tree.map(jnp.asarray, precs), "scalar")
    tb = make_bank({k: torch.from_numpy(v) for k, v in means.items()},
                   {k: torch.from_numpy(v) for k, v in precs.items()},
                   "scalar")
    for s in range(S):
        want = jsteps.bank_round_state(jb, s)
        got = tsteps.bank_round_state(tb, s)
        for k in ("mu_g", "mu_s", "lam_g", "lam_s"):
            for name in shapes:
                w = np.asarray(want[k][name].astype(jnp.float32))
                g = got[k][name].to(torch.float32).numpy()
                assert g.tobytes() == w.tobytes(), (s, k, name)
                assert str(got[k][name].dtype).split(".")[-1] == \
                    str(want[k][name].dtype)


def _gap_ok(logits):
    """Rows whose top-2 gap exceeds the bf16 tolerance."""
    top = np.sort(np.asarray(logits, np.float32), -1)
    return (top[:, -1] - top[:, -2]) > 2.0 ** -5 * (1 + np.abs(top[:, -1]))


def test_prefill_and_serve_tokens_match_the_reference():
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg.vocab_size, 4, 16, seed=5)
    jb.pop("labels")
    tb.pop("labels")
    want = np.asarray(jsteps.make_prefill_step(jcfg)(pj, jb))
    got = tsteps.make_prefill_step(tcfg)(pt, tb)
    assert got.dtype == torch.int32 and got.shape == (4,)
    hidden, _ = JM.forward(pj, jcfg, jb["tokens"])
    logits = jnp.einsum("bd,dv->bv", hidden[:, -1],
                        pj["head"].astype(JM.ACT_DTYPE),
                        preferred_element_type=jnp.float32)
    ok = _gap_ok(logits)
    assert ok.any()
    np.testing.assert_array_equal(got.numpy()[ok], want[ok])

    # decode from empty caches, bf16 draws on both sides
    pjb = jax.tree.map(lambda l: l.astype(jnp.bfloat16), pj)
    ptb = tu.tree_map(lambda t: t.to(torch.bfloat16), pt)
    jserve = jsteps.make_serve_step(jcfg)
    tserve = tsteps.make_serve_step(tcfg)
    jc = JM.init_cache(jcfg, 4, 8)
    tc = TM.init_cache(tcfg, 4, 8)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (3, 4, 1))
    seen = 0
    for t in range(3):
        jt = jnp.asarray(toks[t].astype(np.int32))
        pos = np.full((4,), t, np.int32)
        jl, _ = JM.decode_step(pjb, jcfg, jc, jt, jnp.asarray(pos))
        w, jc = jserve(pjb, jc, jt, jnp.asarray(pos))
        g, tc = tserve(ptb, tc, torch.from_numpy(toks[t]).long(),
                       torch.from_numpy(pos).long())
        ok = _gap_ok(jl)
        seen += ok.sum()
        np.testing.assert_array_equal(g.numpy()[ok], np.asarray(w)[ok])
    assert seen > 0
