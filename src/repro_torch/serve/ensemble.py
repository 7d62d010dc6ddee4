"""Bayesian-model-averaging ensemble math for posterior serving
(counterpart of ``repro.serve.ensemble``).

K draws theta_1..theta_K are served as one model,
``p(y | x) ≈ (1/K) Σ_k p(y | x, theta_k)``:

  * prefill runs ONCE, on the anchor draw (k=0); its decode cache is
    copied to a (K, ...) stack (``repro_torch.models.broadcast_cache``)
    whose prompt region is the same for every draw;
  * decode fans out per token over the draws with a SHARED token stream,
    and :func:`predictive_stats` folds the (K, B, V) logits into the
    predictive mean plus per-token uncertainty;
  * the next token is the argmax of the predictive MEAN.

With K=1 every aggregate is the identity, so single-draw ensemble serving
gives the plain prefill + decode loop's tokens and logits, bitwise.

Uncertainty signals per generated token (each (B,), fp32):
``mean_logprob`` (log predictive probability of the emitted token),
``entropy`` (H[p̄]), ``mutual_info`` (H[p̄] − mean_k H[p_k], BALD: 0 at
K=1) and ``token_var`` (Var_k p_k(token)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch import tree as tu
from repro_torch.models import broadcast_cache, prefill_with_cache
from repro_torch.models.model import AttentionFn, flash_attention

PyTree = Any


@dataclasses.dataclass(frozen=True)
class StepStats:
    """Predictive aggregate of one decode step (each (B,))."""
    token: torch.Tensor
    mean_logprob: torch.Tensor
    entropy: torch.Tensor
    mutual_info: torch.Tensor
    token_var: torch.Tensor


def predictive_stats(logits_k: torch.Tensor) -> StepStats:
    """(K, B, V) per-draw logits -> next token from the predictive mean
    plus per-token uncertainty. All math in fp32; the mean over draws is
    taken in log space (logsumexp − log K)."""
    K = logits_k.shape[0]
    logp = torch.log_softmax(logits_k.to(torch.float32), dim=-1)
    mean_logp = torch.logsumexp(logp, dim=0) - math.log(K)
    token = torch.argmax(mean_logp, dim=-1)                       # (B,)
    probs = torch.exp(logp)                                       # (K,B,V)
    h_pred = -(torch.exp(mean_logp) * mean_logp).sum(-1)
    h_each = -(probs * logp).sum(-1)                              # (K,B)
    idx = token[None, :, None].expand(K, -1, 1)
    p_tok = torch.gather(probs, -1, idx)[..., 0]                  # (K,B)
    conf = torch.gather(mean_logp, -1, token[:, None])[:, 0]
    return StepStats(token=token, mean_logprob=conf, entropy=h_pred,
                     mutual_info=h_pred - h_each.mean(0),
                     token_var=p_tok.var(0, unbiased=False))


def ensemble_prefill(draws: PyTree, cfg, prompt: torch.Tensor,
                     cache_len: int, *,
                     enc_embeds: Optional[torch.Tensor] = None,
                     enc_out: Optional[torch.Tensor] = None,
                     attention: AttentionFn = flash_attention,
                     anchor: Optional[PyTree] = None):
    """ONE prefill for the whole ensemble: the anchor draw (k=0) runs the
    prompt and its decode cache is copied to all K draws. The vlm and
    audio families take ``enc_embeds`` or the ``enc_out`` already made
    from it (``prefill_with_cache``). ``anchor``: draw 0 when ``draws``
    is only a block of the ensemble (a mesh rank's). Returns (anchor
    last-token logits (B, V), caches with (K, ...) leaves). The first
    generated token comes from the anchor; ensemble uncertainty starts at
    the second."""
    k = tu.leaves(draws)[0].shape[0]
    if anchor is None:
        anchor = tu.tree_map(lambda t: t[0], draws)
    logits, cache = prefill_with_cache(anchor, cfg, prompt, cache_len,
                                       enc_embeds=enc_embeds,
                                       enc_out=enc_out, attention=attention)
    return logits, broadcast_cache(cache, k)
