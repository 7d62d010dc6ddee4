"""Per-layer recompute (``cfg.remat``) in the port's models.

The reference checkpoints one decoder period and one encoder layer under
``cfg.remat`` and each head chunk of ``chunked_log_lik`` always
(``repro/models/model.py``); the port's ``_Recompute`` does the same at
the same boundaries. For every family's smoke config:

* the gradient of ``log_lik_fn`` with ``remat=True`` equals the one with
  ``remat=False`` bitwise, in bf16 and in fp32 activations; the one
  exception is whisper's encoder, whose output the decoder periods read:
  its cotangent is summed per period and then across periods, so its
  leaves agree to 1e-6 of their largest in fp32 (an order of additions,
  measured 5.5e-7);
* with ``remat=True`` it is held against ``jax.grad`` of the reference's
  ``log_lik_fn`` within ``test_torch_train_loglik_fp32``'s bound (1e-5
  relative norm, fp32 activations);
* a call count shows each period's layers (and each encoder layer) run
  twice per gradient pass with remat on and once with it off, the
  remainder layers once either way;
* the recompute composes with ``torch.func.vmap`` (the engine's chain
  axis): vmapped gradients equal the per-chain ones bitwise.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.func import grad, vmap
from test_torch_models import _enc_embeds, _model_params
from _torch_train_common import fp32_activations  # noqa: F401 (fixture)

import repro.models.model as JM
import repro_torch.models.model as TM
from repro_torch import tree as tu
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get_smoke_config as torch_smoke
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

ARCHS = sorted(ARCH_NAMES)
# the families whose leaves all agree bitwise in bf16 too (whisper's
# encoder leaves take a cotangent summed in another order, above)
BITWISE_BF16 = [a for a in ARCHS if a != "whisper-large-v3"]


def _batch(tcfg, jcfg, B=2, S=24, seed=3):
    """(JAX batch, port batch) of numpy-made tokens and labels, with the
    frames or patches of the encoder families."""
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    np_batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    enc = _enc_embeds(jcfg, B)
    if enc is not None:
        np_batch["enc_embeds"] = enc
    return ({k: jax.numpy.asarray(v) for k, v in np_batch.items()},
            {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                 else torch.from_numpy(v)) for k, v in np_batch.items()})


def _grad(pt, tcfg, bt, remat):
    cfg = dataclasses.replace(tcfg, remat=remat)
    return grad(lambda p: TM.log_lik_fn(p, cfg, bt))(pt)


def _assert_on_equals_off(arch):
    jcfg, tcfg, _, pt = _model_params(arch)
    _, bt = _batch(tcfg, jcfg)
    on, off = _grad(pt, tcfg, bt, True), _grad(pt, tcfg, bt, False)
    for (name, a), b in zip(tu.leaves_with_names(on), tu.leaves(off)):
        if name.startswith("encoder/"):
            tol = 1e-6 * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol, name
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradient_equals_no_remat_fp32(arch, fp32_activations):
    _assert_on_equals_off(arch)


@pytest.mark.parametrize("arch", BITWISE_BF16)
def test_remat_gradient_equals_no_remat_bf16(arch):
    _assert_on_equals_off(arch)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradient_matches_jax(arch, fp32_activations):
    """Both packages with remat on (the reference's ``jax.checkpoint``),
    fp32 activations: every leaf within 1e-5 relative norm."""
    jcfg, tcfg, pj, pt = _model_params(arch)
    assert jcfg.remat and tcfg.remat
    bj, bt = _batch(tcfg, jcfg)
    gj = jax.jit(jax.grad(lambda p: JM.log_lik_fn(p, jcfg, bj)))(pj)
    gt = _grad(pt, tcfg, bt, True)
    for (name, a), b in zip(tu.leaves_with_names(gt), jax.tree.leaves(gj)):
        assert _rel(b, a.numpy()) < 1e-5, name


def _counted(monkeypatch, name):
    calls = []
    fn = getattr(TM, name)

    def wrapped(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(TM, name, wrapped)
    return calls


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b",
                                  "whisper-large-v3"])
def test_each_period_runs_twice_with_remat_and_once_without(arch,
                                                            monkeypatch):
    """One gradient pass: the layers of the full periods and the encoder
    layers run twice with remat on (the forward, then the backward's
    re-run) and once with it off; the remainder layers (recurrentgemma's
    smoke depth is 2 of a 3-layer pattern: no full period) once."""
    jcfg, tcfg, _, pt = _model_params(arch)
    _, bt = _batch(tcfg, jcfg)
    pat, n_full, rem = TM._period_kinds(tcfg)
    layers = _counted(monkeypatch, "_apply_layer")
    enc = _counted(monkeypatch, "_encoder_layer")
    for remat, times in ((True, 2), (False, 1)):
        layers.clear()
        enc.clear()
        _grad(pt, tcfg, bt, remat)
        assert len(layers) == times * n_full * len(pat) + len(rem)
        assert len(enc) == times * tcfg.encoder_layers


def test_recompute_under_vmap_equals_per_chain():
    """qwen3's smoke config, three chains of their own parameters and
    batches: ``vmap(grad)`` through the recompute equals each chain's
    ``grad``, bitwise."""
    tcfg = torch_smoke("qwen3-1.7b")
    g = torch.Generator().manual_seed(0)
    C, B, S = 3, 2, 16
    thetas = tu.tree_map(
        lambda t: t + 0.01 * torch.randn((C,) + t.shape, generator=g),
        TM.init_params(tcfg, g))
    batches = {"tokens": torch.randint(0, tcfg.vocab_size, (C, B, S),
                                       generator=g),
               "labels": torch.randint(0, tcfg.vocab_size, (C, B, S),
                                       generator=g)}
    fn = grad(lambda p, b: TM.log_lik_fn(p, tcfg, b))
    got = vmap(fn)(thetas, batches)
    for c in range(C):
        one = fn(tu.tree_map(lambda t: t[c], thetas),
                 tu.tree_map(lambda t: t[c], batches))
        for a, b in zip(tu.leaves(got), tu.leaves(one)):
            assert torch.equal(a[c], b)


def test_recompute_forward_is_the_plain_forward():
    """Outside a gradient the recompute is the body itself: the forward
    and the log-likelihood with remat on equal remat off, bitwise."""
    jcfg, tcfg, _, pt = _model_params("whisper-large-v3")
    _, bt = _batch(tcfg, jcfg)
    outs = [TM.log_lik_fn(pt, dataclasses.replace(tcfg, remat=r), bt)
            for r in (True, False)]
    assert torch.equal(outs[0], outs[1])
