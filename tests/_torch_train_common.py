"""Helpers shared by the ``test_torch_train*.py`` files, which hold the
port's transformer sampling path against the JAX package: both packages'
smoke configs (narrower still for the reference's interpret-mode
kernel), the same numpy-made parameters and batches on both sides, and
fp32 activations in both models."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
import repro_torch.models.model as TM
from repro.configs import get_smoke_config as jax_smoke
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import params_from_jax

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


def _jax_value_and_grad(jcfg, pj, bj):
    return jax.jit(jax.value_and_grad(lambda p: JM.log_lik_fn(p, jcfg, bj)))(
        pj)
