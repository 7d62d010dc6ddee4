"""Carry state from the JAX package into the port.

Both functions take plain numpy arrays (``np.asarray`` of the JAX
arrays), so the port never imports JAX: ``tree_from_numpy`` turns a
parameter pytree into the port's dict of tensors, and ``bank_from_numpy``
rebuilds a JAX ``SurrogateBank``'s stacked means and precisions as the
port's bank (the global product is recomputed by ``make_bank``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.core.surrogate import SurrogateBank, make_bank

PyTree = Any


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def tree_from_numpy(tree: PyTree, device=None) -> PyTree:
    """Pytree of numpy arrays -> the same structure of tensors."""
    return tu.tree_map(lambda a: _tensor(a, device), tree)


def bank_from_numpy(means: PyTree, precs: PyTree, kind: str,
                    device=None) -> SurrogateBank:
    """A JAX bank's stacked (S, ...) means and precisions -> port bank."""
    return make_bank(tree_from_numpy(means, device),
                     tree_from_numpy(precs, device), kind)
