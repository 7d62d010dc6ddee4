"""Carry state from the JAX package into the port.

Every function takes plain numpy arrays (``np.asarray`` of the JAX
arrays), so the port never imports JAX: ``tree_from_numpy`` turns a
parameter pytree into the port's dict of tensors, ``bank_from_numpy``
rebuilds a JAX ``SurrogateBank``'s stacked means and precisions as the
port's bank (the global product recomputed by ``make_bank``, or the JAX
bank's own carried across: a bank stored in bf16 had its product taken
in fp32 before the cast), and
``params_from_jax`` / ``draws_from_jax`` carry transformer parameters
(one draw, or K stacked draws) across, checked against the port's layout.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.core.surrogate import Gaussian, SurrogateBank, make_bank
from repro_torch.models.model import param_layout

PyTree = Any


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def tree_from_numpy(tree: PyTree, device=None) -> PyTree:
    """Pytree of numpy arrays -> the same structure of tensors."""
    return tu.tree_map(lambda a: _tensor(a, device), tree)


def bank_from_numpy(means: PyTree, precs: PyTree, kind: str,
                    device=None, global_mean: PyTree = None,
                    global_prec: PyTree = None) -> SurrogateBank:
    """A JAX bank's stacked (S, ...) means and precisions -> port bank,
    each leaf in its own dtype (bf16 means stay bf16). With
    ``global_mean``/``global_prec`` (the JAX bank's ``global_``) the
    global product is taken as it is, else recomputed by ``make_bank``."""
    means = tree_from_numpy(means, device)
    precs = tree_from_numpy(precs, device)
    if global_mean is None:
        return make_bank(means, precs, kind)
    return SurrogateBank(means, precs, Gaussian(
        tree_from_numpy(global_mean, device),
        tree_from_numpy(global_prec, device), kind), kind)


def _checked(tree: PyTree, cfg, lead: tuple, device) -> PyTree:
    out = tree_from_numpy(tree, device)
    leaves, treedef = tu.flatten(out)
    want, want_def = tu.flatten(param_layout(cfg))
    if treedef != want_def:
        raise ValueError(f"parameter tree does not match {cfg.name}'s "
                         f"layout: {treedef} vs {want_def}")
    for t, w in zip(leaves, want):
        if tuple(t.shape) != lead + tuple(w.shape):
            raise ValueError(f"leaf of shape {tuple(t.shape)} where "
                             f"{cfg.name} has {lead + tuple(w.shape)}")
    return out


def params_from_jax(tree: PyTree, cfg, device=None) -> PyTree:
    """The JAX package's ``init_params(cfg, key)`` output, as numpy
    arrays (stacked ``blocks`` included), -> the port's parameter tree:
    the same dict structure and leaf names, copied leaf by leaf."""
    return _checked(tree, cfg, (), device)


def draws_from_jax(tree: PyTree, cfg, device=None) -> PyTree:
    """K draws stacked on a leading axis (every leaf (K, ...)), as the
    JAX package's ``EnsembleServer(draws=...)`` takes them -> the port's
    stacked tree."""
    k = tu.leaves(tree)[0].shape[0]
    return _checked(tree, cfg, (k,), device)
