"""The FSGLD witness's streamed reference fit (``tests/_ref_streamed_fit.py``)
against the reference's own ``repro.api.fit_bank_local_sgld``.

The streamed fit runs the reference's local-SGLD steps one at a time and
keeps running float64 moments instead of the ``lax.scan`` trace. With the
same key it must give the reference's per-leaf means and scalar
precisions: means within 1e-6 of the leaf's largest |mean| (the steps are
the same draws; only XLA's fusion of a step outside the scan and the
moments' float64 sums differ), precisions within 1e-5 relative (the
reference's fp32 variance of values ~0.06 whose spread is ~3e-3 carries
~1e-6 relative rounding per element).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.api as japi
import repro.models.model as JM
from repro.configs import get_smoke_config
from _ref_streamed_fit import streamed_scalar_fit
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

FIT_STEPS, MINIBATCH, N_S, SEQ = 6, 4, 16, 16


@pytest.mark.parametrize("arch,step_size", [("qwen3-1.7b", 1e-5),
                                            ("qwen3-1.7b", 1e-4),
                                            ("h2o-danube-1.8b", 1e-5)])
def test_streamed_fit_equals_the_reference_fit(arch, step_size):
    cfg = dataclasses.replace(get_smoke_config(arch), num_layers=1)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (1, N_S, SEQ + 1))
    shard = {"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
             "labels": jnp.asarray(toks[..., 1:], jnp.int32)}
    ll = lambda p, b: JM.log_lik_fn(p, cfg, b)  # noqa: E731
    key = jax.random.PRNGKey(7)
    ref = japi.fit_bank_local_sgld(
        ll, shard, params, key, fit_steps=FIT_STEPS, minibatch=MINIBATCH,
        step_size=step_size, kind="scalar")
    mu, lam = streamed_scalar_fit(
        ll, jax.tree.map(lambda d: d[0], shard), params,
        jax.random.split(key, 1)[0], fit_steps=FIT_STEPS,
        minibatch=MINIBATCH, step_size=step_size)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    for name, rm, m, rl, lm in zip(
            names, jax.tree.leaves(ref.means), jax.tree.leaves(mu),
            jax.tree.leaves(ref.precs), jax.tree.leaves(lam)):
        rm = np.asarray(rm)[0]
        assert m.shape == rm.shape and m.dtype == np.float32, name
        scale = float(np.max(np.abs(rm)))
        assert float(np.max(np.abs(m - rm))) <= 1e-6 * scale, name
        rl = float(np.asarray(rl)[0])
        assert abs(float(lm) - rl) <= 1e-5 * rl, (name, float(lm), rl)
