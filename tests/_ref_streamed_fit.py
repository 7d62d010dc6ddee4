"""The reference's local-SGLD fit for one client, streamed.

``repro.api.fit_bank_local_sgld`` keeps every step of its ``lax.scan``
trace, which at qwen3-1.7b's full width with the embedding and the head
sampled is ~25 GB per client. This harness runs the same steps one at a
time: the body of its ``local_sgld`` (``src/repro/api.py``), jitted, with
the same key splits (``split(key, fit_steps)``, then ``k1, k2``, then
``split(k2, n_leaves)``), ``randint`` over ``[0, n_s)``, ``jax.grad`` of
the caller's ``log_lik_fn`` and ``theta + (h/2)(n_s/m) g + sqrt(h) xi``.
The second half of the steps (``fit_steps // 2`` on) is folded into
running moments, as deviations from theta0 summed in float64 per leaf,
and the result is what ``repro.core.surrogate.fit_scalar_tree(trace,
jitter=lam_floor)`` returns for that trace: the per-leaf means and
``1 / (mean over the leaf of the per-element population variance +
lam_floor)``. It holds theta, one gradient and two float64 moment
buffers, not the trace.

``key`` is the client's own key: what ``fit_bank_local_sgld`` hands
client s is ``jax.random.split(key, S)[s]``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _make_step(log_lik_fn, n_s, minibatch, step_size):
    def step(theta, data_s, kk):
        k1, k2 = jax.random.split(kk)
        idx = jax.random.randint(k1, (minibatch,), 0, n_s)
        batch = jax.tree.map(lambda d: d[idx], data_s)
        g = jax.grad(log_lik_fn)(theta, batch)
        leaves, tdef = jax.tree.flatten(theta)
        gl = jax.tree.leaves(g)
        ks = jax.random.split(k2, len(leaves))
        new = [t + (step_size / 2) * (n_s / minibatch) * gg.astype(t.dtype)
               + jnp.sqrt(step_size) * jax.random.normal(nk, t.shape, t.dtype)
               for t, gg, nk in zip(leaves, gl, ks)]
        return jax.tree.unflatten(tdef, new)
    return jax.jit(step, donate_argnums=0)


def streamed_scalar_fit(log_lik_fn, data_s, theta0, key, *, fit_steps: int,
                        minibatch: int, step_size: float,
                        lam_floor: float = 1e-8):
    """One client's 'scalar' fit: ``data_s`` is that client's shard (leaves
    ``(n_s, ...)``), ``key`` its key. Returns ``(means, precs)`` as
    ``fit_scalar_tree`` does: fp32 means shaped like theta0, fp32 scalar
    precisions."""
    n_s = jax.tree.leaves(data_s)[0].shape[0]
    step = _make_step(log_lik_fn, n_s, minibatch, step_size)
    th0 = [np.asarray(t) for t in jax.tree.leaves(theta0)]
    tdef = jax.tree.structure(theta0)
    acc = [np.zeros(t.shape, np.float64) for t in th0]
    acc2 = [np.zeros(t.shape, np.float64) for t in th0]
    theta = jax.tree.map(jnp.array, theta0)        # a copy: steps donate it
    burn = fit_steps // 2
    for i, kk in enumerate(jax.random.split(key, fit_steps)):
        theta = step(theta, data_s, kk)
        if i < burn:
            continue
        for a, a2, t, t0 in zip(acc, acc2, jax.tree.leaves(theta), th0):
            d = np.asarray(t) - t0
            a += d
            a2 += np.square(d, dtype=np.float64)
            del d
    del theta
    n = fit_steps - burn
    means, precs = [], []
    for a, a2, t0 in zip(acc, acc2, th0):
        m = a / n
        var = np.maximum(a2 / n - m * m, 0.0)
        means.append((t0 + m).astype(np.float32))
        precs.append(np.float32(1.0 / (var.mean() + lam_floor)))
    return jax.tree.unflatten(tdef, means), jax.tree.unflatten(tdef, precs)
