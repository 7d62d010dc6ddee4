"""Conducive gradients (paper Sec 3, Eq. 5-7); counterpart of
``repro.core.conducive``.

    g_s(theta) = grad log q(theta) - (1/f_s) grad log q_s(theta)

Zero-mean under shard selection s ~ Categorical(f) (Lemma 1). Remark 1's
alpha scales the term; alpha = 0 recovers DSGLD.
"""
from __future__ import annotations

from typing import Any

from repro_torch import tree as tu
from repro_torch.core.surrogate import Gaussian, SurrogateBank

PyTree = Any


def conducive_gradient(theta: PyTree, q_global: Gaussian, q_s: Gaussian,
                       f_s, alpha: float = 1.0) -> PyTree:
    """g_s(theta), computed from the two resident surrogates only."""
    g_glob = q_global.grad_log(theta)
    g_loc = q_s.grad_log(theta)
    return tu.tree_map(lambda a, b: alpha * (a - b / f_s), g_glob, g_loc)


def conducive_gradient_from_bank(theta: PyTree, bank: SurrogateBank, s,
                                 f_s, alpha: float = 1.0) -> PyTree:
    """g_s(theta) for client ``s`` of ``bank``."""
    return conducive_gradient(theta, bank.global_, bank.shard(s), f_s, alpha)
