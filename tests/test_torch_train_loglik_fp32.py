"""The port's model against the JAX package in fp32 activations (both
packages' ``ACT_DTYPE`` patched, so the point is the algorithm, not where
each rounds to bf16): (c) ``forward`` / ``chunked_log_lik`` /
``log_lik_fn`` and their gradients against ``jax.grad`` of the
reference's, on converted params of every decoder family's smoke config
(qwen3-1.7b, h2o-danube-1.8b, phi3.5-moe, grok-1, recurrentgemma-2b,
rwkv6-7b: 2 or 3 layers, d 256), and the refusal of a layer kind outside
its family. The bf16 counterpart: ``test_torch_train_loglik_bf16.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.func import grad

import repro.models.model as JM
import repro_torch.models.model as TM
from _torch_train_common import (ARCHS, _batch, _jax_value_and_grad,
                                 _params, _rel, fp32_activations)  # noqa: F401
from repro.configs import get_smoke_config as jax_smoke
from repro_torch import tree as tu
from repro_torch.configs import get_smoke_config as torch_smoke
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)


# ---------------------------------------------------------------------------
# (c) the model's log-likelihood and its gradient, fp32
# ---------------------------------------------------------------------------

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


def test_other_layer_kinds_name_their_item():
    """Every layer kind runs (ROADMAP item 15 is done); an 'xattn' layer in
    a family without an encoder stream is refused, naming the family."""
    cfg = dataclasses.replace(torch_smoke("qwen3-1.7b"),
                              layer_pattern=("xattn",))
    with pytest.raises(ValueError, match="vlm or audio family"):
        TM.forward({}, cfg, torch.zeros(1, 4, dtype=torch.long))
