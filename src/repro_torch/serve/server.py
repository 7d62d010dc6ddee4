"""The ensemble posterior server: K draws, one prefill per request
(counterpart of ``repro.serve.server``).

``EnsembleServer`` is the object behind ``repro_torch.api.FSGLD.serve``
and ``repro_torch.launch.serve``: it holds the stacked (K, ...) posterior
draws, cast once for serving (``repro_torch.models.serving_params``), and
answers a request with one shared prefill plus a per-token decode
fan-out (``repro_torch.serve.ensemble``).

Draw banks (``bank=``, ``refresh()``) need the checkpoint package (ROADMAP
item 11) and raise NotImplementedError; the trace spans of the reference
come with observability (item 12).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch import tree as tu
from repro_torch.core.engine import _not_ported
from repro_torch.models import (ensemble_decode_step, init_params,
                                serving_params)
from repro_torch.serve.ensemble import ensemble_prefill, predictive_stats

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One served request: the greedy BMA token stream plus per-token
    uncertainty (each (B, gen); see ``repro_torch.serve.ensemble``).
    ``prefill_s`` and ``decode_s`` are host seconds around work that ends
    in a device synchronise."""
    tokens: torch.Tensor
    mean_logprob: torch.Tensor
    entropy: torch.Tensor
    mutual_info: torch.Tensor
    token_var: torch.Tensor
    n_draws: int
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EnsembleServer:
    """Serve K posterior draws as one Bayesian-model-averaged model.

    One draw source: ``draws=`` an already-stacked (K, ...) parameter tree
    (moved to ``device`` and cast for serving), or none: ``n_draws`` fresh
    inits from a generator seeded with ``seed`` (shape smoke, no
    posterior), made one at a time so that two fp32 draws never coexist.
    """

    def __init__(self, cfg, *, bank: Optional[str] = None,
                 draws: Optional[PyTree] = None,
                 n_draws: Optional[int] = None, seed: int = 0,
                 device: Any = "cuda"):
        if bank is not None:
            raise _not_ported("serving from a draw bank (bank=)", 11)
        self.cfg = cfg
        self.device = torch.device(device)
        if draws is not None:
            self.draws = serving_params(
                tu.tree_map(lambda t: t.to(self.device), draws))
        else:
            self.draws = self._fresh(n_draws or 1, seed)

    def _fresh(self, k: int, seed: int) -> PyTree:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        stacked = None
        for i in range(k):
            draw = serving_params(init_params(self.cfg, gen, self.device))
            if stacked is None:
                stacked = tu.tree_map(
                    lambda t: t.new_empty((k,) + tuple(t.shape)), draw)
            tu.tree_map(lambda s, t: s[i].copy_(t), stacked, draw)
            del draw
        return stacked

    @property
    def n_draws(self) -> int:
        return int(tu.leaves(self.draws)[0].shape[0])

    def refresh(self, **_) -> bool:
        raise _not_ported("draw-bank refresh()", 11)

    def generate(self, prompt: Optional[torch.Tensor] = None, *,
                 generator: Optional[torch.Generator] = None, gen: int = 16,
                 batch: int = 4, prompt_len: int = 32) -> ServeResult:
        """Serve one request: greedy decode ``gen`` tokens from the
        ensemble predictive mean. ``prompt`` (B, S) integer, or None to
        draw a random prompt from ``generator`` (on the server's device;
        default seeded 0). Token 0 comes from the shared anchor prefill;
        ensemble fan-out statistics start at token 1."""
        cfg, dev = self.cfg, self.device
        if prompt is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=generator, device=dev)
        prompt = prompt.to(dev)
        B, S = prompt.shape
        total = S + gen

        _sync(dev)
        t0 = time.perf_counter()
        logits0, caches = ensemble_prefill(self.draws, cfg, prompt, total)
        # token 0: the anchor's logits as a one-draw ensemble
        stats = [predictive_stats(logits0[None])]
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        tok = stats[0].token[:, None]
        for t in range(S, total - 1):
            pos = torch.full((B,), t, dtype=torch.int64, device=dev)
            logits_k, caches = ensemble_decode_step(self.draws, cfg, caches,
                                                    tok, pos)
            stats.append(predictive_stats(logits_k))
            tok = stats[-1].token[:, None]
        _sync(dev)
        decode_s = time.perf_counter() - t0

        def col(f):
            return torch.stack([f(s) for s in stats], dim=1)

        return ServeResult(
            tokens=col(lambda s: s.token),
            mean_logprob=col(lambda s: s.mean_logprob),
            entropy=col(lambda s: s.entropy),
            mutual_info=col(lambda s: s.mutual_info),
            token_var=col(lambda s: s.token_var),
            n_draws=self.n_draws, prefill_s=prefill_s, decode_s=decode_s)
