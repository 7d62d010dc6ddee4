"""The ensemble posterior server: K draws, one prefill per request,
hot-swapped draw banks (counterpart of ``repro.serve.server``).

``EnsembleServer`` is the object behind ``repro_torch.api.FSGLD.serve``
and ``repro_torch.launch.serve``: it holds the stacked (K, ...) posterior
draws, cast once for serving (``repro_torch.models.serving_params``),
answers a request with one shared prefill plus a per-token decode
fan-out (``repro_torch.serve.ensemble``), and between requests polls its
draw-bank directory for fresh draws written by a still-running sampler
(``repro_torch.launch.train --draw-bank``): ``refresh()`` hot-swaps the
newest K draws in without restarting the server.

A bank's draws are fingerprint-checked against a skeleton of meta
tensors built from ``models.param_layout`` (no parameter is made), and
loaded, moved to the device and cast one draw at a time, so two fp32
full-width draws never sit on the card at once. Each request emits the
reference's ``serve.prefill`` / ``serve.decode`` spans (each ending after
a device synchronize, so its duration is ``ServeResult.prefill_s`` /
``decode_s``'s interval) and a ``serve.request`` event
(``repro_torch.obs.trace``).

The vlm and audio families take a request's stubbed frontend output
(image patches, audio frames; drawn from the request's generator unless
given): for audio the anchor draw encodes the frames once per request,
and prefill and every decode step read that output.

On a mesh (``mesh=``, a ``launch.mesh`` DeviceMesh, every rank serving
the same requests) the K draws ride the 'data' axis when K divides it
(``sharding.rules.ensemble_spec``; replicated otherwise): each rank
builds the K draws, keeps its block and the anchor (draw 0), prefills
on the anchor, decodes its block, and gathers the (K, B, V) logits in
draw order before ``predictive_stats``, so every rank serves the
one-device tokens and statistics.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, List, Optional

import torch

from repro_torch import checkpoint
from repro_torch import tree as tu
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import mesh as lmesh
from repro_torch.models import (encoder_stream, ensemble_decode_step,
                                init_leaves, param_layout, serving_cast,
                                serving_params)
from repro_torch.models.model import ENCODER_FAMILIES
from repro_torch.obs import trace as obs_trace
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


def skeleton(cfg) -> PyTree:
    """The parameter tree of ``cfg`` as meta tensors (names, shapes and
    dtypes, no memory): what draws are fingerprint-checked against."""
    dtype = getattr(torch, cfg.param_dtype)
    return tu.tree_map(lambda leaf: torch.empty(leaf.shape, dtype=dtype,
                                                device="meta"),
                       param_layout(cfg))


def _stack_into(stacked: Optional[PyTree], k: int, i: int,
                draw: PyTree) -> PyTree:
    """Write ``draw`` into slot ``i`` of a (k, ...) stack shaped like it,
    allocated on first use."""
    if stacked is None:
        stacked = tu.tree_map(
            lambda t: t.new_empty((k,) + tuple(t.shape)), draw)
    tu.tree_map(lambda s, t: s[i].copy_(t), stacked, draw)
    return stacked


class EnsembleServer:
    """Serve K posterior draws as one Bayesian-model-averaged model.

    One draw source:
      * ``bank=`` a draw-bank directory (or a legacy single-checkpoint
        dir): its freshest ``n_draws`` (all when None) are loaded,
        fingerprint-checked against this arch's skeleton, and
        ``refresh()`` keeps tracking the directory;
      * ``draws=`` an already-stacked (K, ...) parameter tree (moved to
        ``device`` and cast for serving);
      * neither: ``n_draws`` fresh inits from a generator seeded with
        ``seed`` (shape smoke, no posterior).
    Draws are cast one at a time, so two fp32 draws never coexist.
    ``mesh``: see the module docstring; ``draws`` then holds this rank's
    block and ``anchor`` draw 0.
    """

    def __init__(self, cfg, *, bank: Optional[str] = None,
                 draws: Optional[PyTree] = None,
                 n_draws: Optional[int] = None, seed: int = 0,
                 device: Any = "cuda", mesh: Any = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.bank = bank
        self._draws = self.anchor = None
        self._k = 0
        self.sharded = False
        self.metas: List[Optional[checkpoint.DrawMeta]] = []
        self._seen_draws = 0
        if bank is not None:
            if draws is not None:
                raise ValueError("pass bank= or draws=, not both")
            self._like = skeleton(cfg)
            self._want = n_draws
            self.draws = None
            if not self.refresh():
                raise ValueError(f"no draws in bank {bank!r}")
        elif draws is not None:
            self.draws = serving_params(
                tu.tree_map(lambda t: t.to(self.device), draws))
            self.metas = [None] * self.n_draws
        else:
            self.draws = self._fresh(n_draws or 1, seed)
            self.metas = [None] * self.n_draws

    def _fresh(self, k: int, seed: int) -> PyTree:
        """``k`` fresh inits from one generator seeded with ``seed``, cast
        as ``serving_params`` casts them (its values, bitwise). Each leaf
        goes into its slot of the (k, ...) stack as it is drawn, in the
        dtype ``serving_cast`` gives it, so no whole fp32 draw is held: at
        phi3.5-moe's width the largest leaf is 13 GB in fp32, a whole
        8-layer draw 43 GB."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cast, treedef = tu.flatten(serving_cast(skeleton(self.cfg)))
        stack = [torch.empty((k,) + tuple(t.shape), dtype=t.dtype,
                             device=self.device) for t in cast]
        for i in range(k):
            leaves = init_leaves(self.cfg, gen, self.device)
            for j in range(len(stack)):
                # no loop variable or enumerate tuple may hold a leaf
                # while the next one is drawn
                t = next(leaves)
                stack[j][i].copy_(t)
                del t
        return serving_params(tu.unflatten(treedef, stack))

    def _load(self, k: int):
        """The freshest ``k`` servable draws of the bank, stacked on the
        device and cast, oldest first, with their metas: each draw is
        read on the host, moved, cast and written into its slot before
        the next is read."""
        stacked, metas, i = None, [], k
        for tree, meta in checkpoint.iter_bank(
                self.bank, self._like, k=k, expect_arch=self.cfg.name):
            i -= 1
            draw = serving_params(
                tu.tree_map(lambda t: t.to(self.device), tree))
            del tree
            stacked = _stack_into(stacked, k, i, draw)
            del draw
            metas.insert(0, meta)
        if i:          # corrupt draws skipped: fewer than k were served
            stacked = tu.tree_map(lambda t: t[i:].clone(), stacked)
        return stacked, metas

    @property
    def draws(self) -> PyTree:
        """The served draws this rank holds, stacked (K, ...), or its
        block of them when they ride the mesh's 'data' axis."""
        return self._draws

    @draws.setter
    def draws(self, stacked: Optional[PyTree]) -> None:
        """Install all K stacked draws: on a mesh whose 'data' axis
        divides K, keep this rank's block (and draw 0 as the anchor)."""
        self._draws = self.anchor = None
        if stacked is None:
            self._k, self.sharded = 0, False
            return
        k = int(tu.leaves(stacked)[0].shape[0])
        d = lmesh.axis_size(self.mesh, "data")
        self._k, self.sharded = k, self.mesh is not None and k % d == 0
        anchor = tu.tree_map(lambda t: t[0], stacked)
        if self.sharded and d > 1:
            per = k // d
            lo = lmesh.axis_rank(self.mesh, "data") * per
            if lo:
                anchor = tu.tree_map(lambda t: t.clone(), anchor)
            stacked = tu.tree_map(lambda t: t[lo:lo + per].clone(), stacked)
            if not lo:
                anchor = tu.tree_map(lambda t: t[0], stacked)
        self._draws, self.anchor = stacked, anchor

    @property
    def n_draws(self) -> int:
        """K, the draws the ensemble averages (over every rank)."""
        return self._k

    def refresh(self, *, retries: int = 2,
                backoff_s: float = 0.05) -> bool:
        """Poll the draw bank; when new complete draws appeared since the
        last load, hot-swap the freshest ``n_draws`` in. Returns True when
        the ensemble changed; False (a no-op) for servers without a bank.

        Transient read failures (``OSError``, a torn-write
        ``CorruptCheckpointError``) are retried ``retries`` times with
        exponential backoff from ``backoff_s``; refusals (arch or
        fingerprint mismatch, a wholly corrupt bank) are not. Once an
        ensemble is live a failed refresh keeps it serving (a warning and
        False): only the INITIAL load raises."""
        if self.bank is None:
            return False
        avail = len(checkpoint.list_draws(self.bank))
        if avail == 0 and os.path.exists(
                os.path.join(self.bank, "manifest.json")):
            avail = 1  # legacy single-checkpoint fallback: one draw
        if avail == 0 or (avail == self._seen_draws
                          and self.draws is not None):
            return False
        k = self._want if self._want is not None else avail
        k = min(k, avail)  # sampler still filling the bank: serve what exists
        loaded = None
        last_exc: Optional[Exception] = None
        with obs_trace.span("server.refresh", bank=self.bank, avail=avail):
            for attempt in range(retries + 1):
                try:
                    loaded = self._load(k)
                    last_exc = None
                    break
                except (checkpoint.CorruptCheckpointError, OSError) as e:
                    last_exc = e
                    obs_trace.event(
                        "server.refresh_retry", attempt=attempt,
                        retries=retries, error=str(e),
                        backoff_s=(backoff_s * (2 ** attempt)
                                   if attempt < retries else 0.0))
                    if attempt < retries:
                        time.sleep(backoff_s * (2 ** attempt))
                except ValueError as e:  # refusal: retrying cannot help
                    last_exc = e
                    obs_trace.event("server.refresh_refused", error=str(e))
                    break
        if last_exc is not None:
            if self.draws is not None:
                warnings.warn(
                    f"draw-bank refresh failed ({last_exc}); keeping the "
                    f"previous {self.n_draws}-draw ensemble live")
                obs_trace.event("server.refresh_failed", error=str(last_exc),
                                kept_draws=self.n_draws)
                return False
            raise last_exc
        self.draws, self.metas = loaded
        self._seen_draws = avail
        return True

    def _encoder_inputs(self, generator: torch.Generator, batch: int,
                        enc_embeds: Optional[torch.Tensor]):
        """The stream a request's 'xattn' layers attend to
        (``models.encoder_stream`` on the anchor draw: the vlm family's
        patches (B, num_patches, D) cast to bf16, the encoder's output of
        the audio family's frames (B, encoder_seq, D)); standard normals
        from ``generator`` unless ``enc_embeds`` is given. None for the
        other families."""
        cfg, dev = self.cfg, self.device
        if cfg.family not in ENCODER_FAMILIES:
            return None
        if enc_embeds is None:
            T = cfg.num_patches if cfg.family == "vlm" else cfg.encoder_seq
            enc_embeds = torch.randn((batch, T, cfg.d_model),
                                     generator=generator, device=dev)
        return encoder_stream(self.anchor, cfg, enc_embeds.to(dev),
                              attention=flash_attention)

    def _decode_logits(self, caches, tok, pos, enc_out):
        """One decode step of the draws held here; on a sharded mesh the
        (K, B, V) logits of every rank's block, in draw order."""
        logits_k, caches = ensemble_decode_step(
            self.draws, self.cfg, caches, tok, pos, enc_out=enc_out)
        if self.sharded:
            logits_k = lmesh.all_gather_rows(logits_k, self.mesh, "data")
        return logits_k, caches

    def generate(self, prompt: Optional[torch.Tensor] = None, *,
                 generator: Optional[torch.Generator] = None, gen: int = 16,
                 batch: int = 4, prompt_len: int = 32,
                 enc_embeds: Optional[torch.Tensor] = None) -> ServeResult:
        """Serve one request: greedy decode ``gen`` tokens from the
        ensemble predictive mean. ``prompt`` (B, S) integer, or None to
        draw a random prompt from ``generator`` (on the server's device;
        default seeded 0). The vlm and audio families' ``enc_embeds``
        (B, T, D), or None to draw them from ``generator`` after the
        prompt; the audio encoder runs once, on the anchor, inside the
        prefill's span. Token 0 comes from the shared anchor prefill;
        ensemble fan-out statistics start at token 1."""
        cfg, dev = self.cfg, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if prompt is None:
            prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=generator, device=dev)
        prompt = prompt.to(dev)
        B, S = prompt.shape
        total = S + gen

        # each span ends after a synchronize, so its duration is the
        # card's, the same interval prefill_s / decode_s measure
        _sync(dev)
        with obs_trace.span("serve.prefill", batch=B, prompt_len=S,
                            n_draws=self.n_draws):
            t0 = time.perf_counter()
            enc_out = self._encoder_inputs(generator, B, enc_embeds)
            logits0, caches = ensemble_prefill(self.draws, cfg, prompt,
                                               total, enc_out=enc_out,
                                               anchor=self.anchor)
            # token 0: the anchor's logits as a one-draw ensemble
            stats = [predictive_stats(logits0[None])]
            _sync(dev)
            prefill_s = time.perf_counter() - t0

        with obs_trace.span("serve.decode", batch=B, gen=gen,
                            n_draws=self.n_draws):
            t0 = time.perf_counter()
            tok = stats[0].token[:, None]
            for t in range(S, total - 1):
                pos = torch.full((B,), t, dtype=torch.int64, device=dev)
                logits_k, caches = self._decode_logits(caches, tok, pos,
                                                       enc_out)
                stats.append(predictive_stats(logits_k))
                tok = stats[-1].token[:, None]
            _sync(dev)
            decode_s = time.perf_counter() - t0
        if obs_trace.enabled():
            obs_trace.event(
                "serve.request", batch=B, prompt_len=S, gen=gen,
                n_draws=self.n_draws,
                prefill_s=round(prefill_s, 6), decode_s=round(decode_s, 6),
                tokens_per_s=round(
                    B * max(gen - 1, 1) / max(decode_s, 1e-9), 3))

        def col(f):
            return torch.stack([f(s) for s in stats], dim=1)

        return ServeResult(
            tokens=col(lambda s: s.token),
            mean_logprob=col(lambda s: s.mean_logprob),
            entropy=col(lambda s: s.entropy),
            mutual_info=col(lambda s: s.mutual_info),
            token_var=col(lambda s: s.token_var),
            n_draws=self.n_draws, prefill_s=prefill_s, decode_s=decode_s)
