"""Step functions of the production runtime (counterpart of
``repro.launch.steps``): the FSGLD update of the whole transformer
posterior with per-tensor scalar surrogates, which the dry run traces
for every architecture, and the serving steps ``prefill_step`` and
``serve_step``. The sampling loop itself runs on the chain engine
(``repro_torch.api.FSGLD``).

The surrogate operand of ``train_step`` is the flat ``{mu_g, mu_s,
lam_g, lam_s}`` dict a 'scalar' ``core.surrogate.SurrogateBank`` lowers
to for one round (``bank_round_state`` / ``init_surrogate_state``).

Documented deviation: the reference draws ``jax.random.normal`` per leaf
key. Here ``train_step`` takes one integer seed per leaf (or a
``torch.Generator``, from which ``kernels.ops.chain_leaf_seeds`` draws
them) and the update kernel makes each element's normal from a counter
hash of (seed, the element's index in its leaf), as the chain engine
does.

Parameters may be ``torch.distributed.tensor.DTensor``s laid out by
``sharding.rules`` (the dry run's): the log-likelihood's gradient is
taken through DTensor, each leaf's gradient is placed as its parameter
is, and the update runs on every rank's local shard with the segment
table of that shard's elements in the whole leaf, so a sharded update
draws the noise the unsharded one draws.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig, SamplerConfig
from repro_torch.core.surrogate import Gaussian
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fsgld_update import LANE, fsgld_update_2d
from repro_torch.models import (decode_step, forward, log_lik_fn,
                                serving_params)
from repro_torch.models.layers import unsharded
from repro_torch.models.model import ACT_DTYPE

PyTree = Any


# ---------------------------------------------------------------------------
# the surrogate operand
# ---------------------------------------------------------------------------

def make_surrogate_state(params_shape: PyTree,
                         dtype=torch.bfloat16) -> PyTree:
    """Meta stand-ins of the surrogate operand: global and resident-client
    means shaped like the parameters (bf16) and one fp32 scalar
    precision per leaf."""
    means = tu.tree_map(lambda l: torch.empty(l.shape, dtype=dtype,
                                              device="meta"), params_shape)
    lams = tu.tree_map(lambda l: torch.empty((), dtype=torch.float32,
                                             device="meta"), params_shape)
    return {"mu_g": means, "mu_s": means, "lam_g": lams, "lam_s": lams}


def init_surrogate_state(params: PyTree, *, lam: float = 1e-4,
                         dtype=torch.bfloat16) -> PyTree:
    """The surrogate operand centred on ``params`` (the operand a
    one-client bank at ``params`` lowers to): means cast to ``dtype``,
    every precision ``lam``."""
    means = tu.tree_map(lambda p: p.to(dtype), params)
    lams = tu.tree_map(lambda p: torch.tensor(lam, dtype=torch.float32,
                                              device=p.device), params)
    return {"mu_g": means, "mu_s": means, "lam_g": lams, "lam_s": lams}


def bank_round_state(bank, s, dtype=torch.bfloat16) -> PyTree:
    """A 'scalar' SurrogateBank -> the per-round operand of
    ``train_step``: the global and client ``s`` means at ``dtype``, their
    precisions fp32."""
    assert bank.kind == "scalar", bank.kind
    q_s = bank.shard(s)
    cast = lambda t: tu.tree_map(lambda l: l.to(dtype), t)  # noqa: E731
    f32 = lambda t: tu.tree_map(  # noqa: E731
        lambda l: torch.as_tensor(l).to(torch.float32), t)
    return {"mu_g": cast(bank.global_.mean), "mu_s": cast(q_s.mean),
            "lam_g": f32(bank.global_.prec), "lam_s": f32(q_s.prec)}


# ---------------------------------------------------------------------------
# the update of one leaf's shard
# ---------------------------------------------------------------------------

def shard_runs(global_shape, local_shape, offset) -> tuple:
    """A shard of a row-major tensor as runs that are contiguous in the
    whole tensor: (first flat index of each run (n,) int64, run length).
    The runs are the shard's rows along its innermost sharded dim (every
    dim after it whole); a whole tensor is one run."""
    gs, ls, off = list(global_shape), list(local_shape), list(offset)
    split = [d for d in range(len(gs)) if ls[d] != gs[d]]
    if not split:
        return torch.zeros(1, dtype=torch.int64), math.prod(ls)
    k = split[-1]
    stride = [math.prod(gs[d + 1:]) for d in range(len(gs))]
    base = torch.tensor([off[k] * stride[k]], dtype=torch.int64)
    for d in range(k):
        col = (torch.arange(ls[d], dtype=torch.int64) + off[d]) * stride[d]
        base = (base[:, None] + col[None, :]).reshape(-1)
    return base, math.prod(ls[k:])


def update_shard(th, g, seed, *, global_shape, offset, h, scale, f_s,
                 prior_prec, alpha, temperature, mu_g=None, mu_s=None,
                 lam_g=None, lam_s=None):
    """The update of one local shard ``th`` (its place in the whole leaf:
    ``global_shape`` and the shard's ``offset`` per dim) with its
    gradient and surrogate-mean shards: one ``fsgld_update_2d`` launch
    whose segment table holds each block's first index in the whole leaf
    (runs padded to 128 lanes, one row per block when the shard has more
    than one run). Returns theta' in th's dtype."""
    dev = th.device
    bases, run = shard_runs(global_shape, th.shape, offset)
    n = bases.shape[0]
    br = 8 if n == 1 else 1
    rows = -(-run // (br * LANE)) * br        # per run

    def lay(x):
        buf = torch.zeros(n, rows * LANE, dtype=torch.float32, device=dev)
        buf[:, :run] = x.reshape(n, run)
        return buf.reshape(-1, LANE)

    blocks = (bases[:, None] + torch.arange(0, rows * LANE, br * LANE,
                                            dtype=torch.int64)[None])
    seg_base = (blocks.reshape(-1) & 0xFFFFFFFF).to(torch.int32).to(dev)
    kw = {}
    lams = (0.0, 0.0)
    if mu_g is not None:
        kw = {"mu_g": lay(mu_g), "mu_s": lay(mu_s)}
        lams = (lam_g, lam_s)
    sc = kops._scalars_row(dev, h, scale, f_s, prior_prec, alpha,
                           temperature, *lams)
    out = fsgld_update_2d(lay(th), lay(g), seed.reshape(1), sc,
                          variant="plain" if mu_g is None else "scalar",
                          block_rows=br, seg_base=seg_base, **kw)
    return out.reshape(n, -1)[:, :run].reshape(th.shape).to(th.dtype)


def local_shape_and_offset(shape, mesh, placements) -> tuple:
    """This rank's shard of a tensor of ``shape`` placed by
    ``placements`` on ``mesh``: (its shape, its offset per dim). Computed
    outside every dispatch mode (DTensor finds the rank's coordinate with
    tensor ops, which a fake mode would make data-dependent)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        local, off = compute_local_shape_and_global_offset(
            tuple(shape), mesh, placements)
    return tuple(local), tuple(off)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _dtensor_update(th, g, seed, mu_g, mu_s, lam_g, lam_s, **kw):
    """``update_shard`` on this rank's shard of a DTensor leaf: the
    gradient (and the surrogate means) placed as the parameter is, the
    result wrapped back with the parameter's placements."""
    from torch.distributed.tensor import DTensor
    mesh, pl = th.device_mesh, th.placements

    def local(t):
        if t is None:
            return None
        if isinstance(t, DTensor):
            if t.placements != pl:
                t = t.redistribute(mesh, pl)
            return t.to_local()
        return t

    _, offset = local_shape_and_offset(th.shape, mesh, pl)
    lam = (lambda t: t.full_tensor() if isinstance(t, DTensor) else t)
    out = update_shard(local(th), local(g), local(seed), global_shape=th.shape,
                       offset=offset, mu_g=local(mu_g), mu_s=local(mu_s),
                       lam_g=None if lam_g is None else lam(lam_g),
                       lam_s=None if lam_s is None else lam(lam_s), **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=th.shape, stride=th.stride())


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, sampler: SamplerConfig, *,
                    scale: float, f_s: float):
    """FSGLD train step: one Langevin update of the model-posterior chain.

    scale = N_s / (f_s * m), the DSGLD unbiasing factor. Returns
    ``train_step(params, surr, batch, seeds)``: ``seeds`` (L,) integers,
    one per leaf in flatten order, or a ``torch.Generator`` to draw them
    from; ``surr`` the 'scalar' operand. One value-and-grad of
    ``models.log_lik_fn`` (``cfg.remat`` recomputes each period in the
    backward), then the per-leaf update kernel, variant 'scalar' with
    alpha = ``sampler.alpha`` for FSGLD ('plain', alpha 0, otherwise):
    one ``fsgld_update_2d`` launch per leaf. Returns (new params,
    {"log_lik", "ll_per_token"})."""
    alpha = sampler.alpha if sampler.method == "fsgld" else 0.0
    hyper = dict(h=sampler.step_size, scale=scale, f_s=f_s,
                 prior_prec=sampler.prior_precision, alpha=alpha,
                 temperature=sampler.temperature)

    def train_step(params, surr, batch, seeds):
        leaves, treedef = tu.flatten(params)
        if isinstance(seeds, torch.Generator):
            seeds = kops.chain_leaf_seeds(seeds, len(leaves))
        xs = [l.detach().requires_grad_(True) for l in leaves]
        with torch.enable_grad():
            ll = log_lik_fn(tu.unflatten(treedef, xs), cfg, batch)
            grads = torch.autograd.grad(ll, xs)
        ll = ll.detach()
        del xs
        theta = [l.detach() for l in leaves]
        ops = ((None,) * 4 if not alpha else
               tuple(tu.leaves(surr[k])
                     for k in ("mu_g", "mu_s", "lam_g", "lam_s")))
        if any(_is_dtensor(t) for t in theta):
            L = len(theta)
            ops = [o if o is not None else [None] * L for o in ops]
            new = [_dtensor_update(t, g, seeds[i], ops[0][i], ops[1][i],
                                   ops[2][i], ops[3][i], **hyper)
                   for i, (t, g) in enumerate(zip(theta, grads))]
            new_params = tu.unflatten(treedef, new)
        else:
            q = {}
            if alpha:
                q = dict(q_global=Gaussian(tu.unflatten(treedef, ops[0]),
                                           tu.unflatten(treedef, ops[2]),
                                           "scalar"),
                         q_shard=Gaussian(tu.unflatten(treedef, ops[1]),
                                          tu.unflatten(treedef, ops[3]),
                                          "scalar"),
                         surrogate_kind="scalar")
            new_params = kops.fused_update_tree(
                tu.unflatten(treedef, theta), tu.unflatten(treedef, grads),
                seeds, **hyper, **q)
        metrics = {"log_lik": ll,
                   "ll_per_token": ll / batch["tokens"].numel()}
        return new_params, metrics

    return train_step


def _last_logits(hidden: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The last position's logits: bf16 values, fp32 products and sums."""
    return hidden[:, -1].to(torch.float32) @ \
        head.to(ACT_DTYPE).to(torch.float32)


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row, int32; on a pod mesh the vocab is
    gathered first (DTensor cannot reduce an argmax across shards)."""
    return torch.argmax(unsharded(logits, -1), -1).to(torch.int32)


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch)``: the forward over the prompt (the
    serving flash entry, one launch per attention layer) and the argmax
    of the last position's logits, int32 (B,)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            hidden, _ = forward(params, cfg, batch["tokens"],
                                enc_embeds=batch.get("enc_embeds"),
                                attention=flash_attention)
            logits = _last_logits(hidden, params["head"])
        return _argmax(logits)
    return prefill_step


def make_serve_step(cfg: ArchConfig, *, with_enc: Optional[bool] = None):
    """``serve_step(params, cache, token, pos[, enc_out])``: one
    ``models.decode_step`` of a bf16 draw (the head widened to fp32 for
    the logits product inside the step) and the argmax, int32 (B,), with
    the cache updated in place. ``enc_out`` is required for the vlm and
    audio families (``with_enc``)."""
    with_enc = (cfg.family in ("vlm", "audio")) if with_enc is None \
        else with_enc

    def serve_step(params, cache, token, pos, enc_out=None):
        if with_enc and enc_out is None:
            raise ValueError(f"{cfg.name} ({cfg.family}) needs enc_out")
        with torch.no_grad():
            logits, cache = decode_step(serving_params(params), cfg, cache,
                                        token, pos,
                                        enc_out=enc_out if with_enc
                                        else None)
        return _argmax(logits), cache
    return serve_step
