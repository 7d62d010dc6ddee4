"""The language models of every family (counterpart of
``repro.models.model``): parameters, the training forward and
log-likelihood, the encoder, the cache-populating prefill and the
single-token decode step.

Parameters are plain nested dicts of tensors in the JAX package's layout:
``embed`` (V, D), ``blocks`` with every leaf stacked over the full
periods of ``cfg.layer_pattern`` (leading axis, layer keys ``l0``...),
``rem_blocks`` for a remainder, ``final_norm`` (D,) and ``head`` (D, V),
and for the audio family ``encoder`` ({'blocks': 'attn' layers stacked
over ``cfg.encoder_layers``, 'final_norm'}), with the same leaf names, so
a JAX parameter tree converts leaf by leaf
(``repro_torch.convert.params_from_jax``). A Python loop over the
layers takes the place of ``lax.scan``.

Precision follows the reference: fp32 master parameters cast to bf16 at
the point of use (prefill per layer, but not ``final_norm``; decode all
of them), bf16 activations, and the head product with fp32 products and
sums (JAX's ``preferred_element_type=float32``). ``serving_params``
does those casts once for a served draw.

Layer kinds 'attn', 'swa' (ring cache), 'rglru' and 'rwkv' (recurrent
states in the cache) run, with the dense or the MoE FFN, and 'xattn':
for the vlm family a gated cross-attention to the image patches (its
output scaled by tanh(gate), the gate 0 at init), for the audio family
self-attention then cross-attention to the encoder's output. The
cross-attention's keys and values are the encoder stream's (``enc_out``:
the patches cast to bf16 for vlm, ``encoder_forward`` of the frames for
audio), projected again at every decode step as in the reference (no
cross cache), with every position 0 and no mask; it runs the plain
``layers.chunked_attention`` on every device, as the reference runs its
pure-JAX scan there (the flash kernel takes Sq == Sk only). ``forward`` / ``chunked_log_lik`` / ``log_lik_fn`` are the sampling
path's likelihood, differentiated by ``torch.func.grad`` (and vmapped
over chains by the engine): their attention is ``flash_attention_diff``,
the kernel with the reference's flash backward, and the likelihood
carries the MoE router's load-balance term, as the reference's does.

Recompute (the reference's ``jax.checkpoint``) sits at the reference's
three boundaries: one decoder period of ``cfg.layer_pattern`` and one
encoder layer when ``cfg.remat`` is set (the remainder layers never),
and each head chunk of ``chunked_log_lik`` always. Each is one
``_Recompute`` call, an ``autograd.Function`` that keeps only its
inputs and re-runs its body in the backward: functorch's transforms take
no saved-tensor hooks, so ``torch.utils.checkpoint`` cannot serve. RWKV's
pairwise decays are recomputed inside the period's backward by their own
``layers._RwkvScores``, as the reference's checkpointed chunk body
recomputes them.

On a pod mesh (DTensor parameters laid out by ``sharding.rules``: the
dry run) the activations are anchored as the reference anchors them
(``_shard_batch`` at its eight sites: the residual stream batch-sharded
over ('pod', 'data') at each period boundary, replicated on 'model'),
and the ops DTensor would otherwise replicate or gather are placed as
XLA partitions the reference: each attention's operands
(``layers.attention_layout``; its input reduced first where it holds a
pending sum, ``layers.summed``), each layer's weights gathered over the
batch axes at their point of use (FSDP), the FFN's input, the head's
logits reduced shard-wise over the vocabulary (``_VocabSum``), the
embedding as a vocab-parallel lookup, the decode cache written slot-wise
on its own shards. A recomputed body then re-runs under autograd
(``_recorded_vjp``), where the anchors see the DTensors. A plain tensor
passes through all of this unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_diff)
from repro_torch.models import layers as L

ACT_DTYPE = torch.bfloat16
# the families whose 'xattn' layers attend to a second input stream
ENCODER_FAMILIES = ("vlm", "audio")
# the router's load-balance term enters the log-likelihood with this
# weight per token, as in the reference
AUX_WEIGHT = 0.01


def _check_runs(cfg: ArchConfig) -> None:
    """Refuse what no model of the repository is: 'xattn' layers without
    an encoder stream (a family other than vlm and audio), or an encoder
    outside the audio family."""
    if "xattn" in cfg.layer_pattern and cfg.family not in ENCODER_FAMILIES:
        raise ValueError(f"{cfg.name}: 'xattn' layers need the vlm or audio "
                         f"family's encoder stream, not {cfg.family!r}")
    if cfg.encoder_layers and cfg.family != "audio":
        raise ValueError(f"{cfg.name}: an encoder needs the audio family, "
                         f"not {cfg.family!r}")


# the reference's activation anchor (``repro.models.model._shard_batch``)
_shard_batch = L.shard_batch


def _cast_floating(tree, dtype=ACT_DTYPE):
    """Float leaves to the compute dtype at the point of use (a leaf
    already in it is returned as is, not copied)."""
    return tu.tree_map(
        lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens]. A DTensor table (its vocab sharded over 'model', the
    dry run's) looked up by batch-sharded tokens goes through
    ``aten.embedding``, whose DTensor rule looks up each rank's vocab
    shard and reduces the masked rows (the vocab-parallel lookup XLA
    partitions the reference's gather into); replicated tokens (a batch
    of one) take ``_VocabLookup``, the same lookup written out, since
    torch 2.11's rule fails on them and DTensor's indexing gathers the
    whole table."""
    if L._dtensor(table) is None:
        return table[tokens]
    tok = L._dtensor(tokens)
    if tok is not None and any(p.is_shard() for p in tok.placements):
        return F.embedding(tokens, table)
    if tok is not None:
        tokens = tok.to_local()
    return _VocabLookup.apply(table, tokens)


class _VocabLookup(torch.autograd.Function):
    """table[tokens] of a DTensor table (V, D) by tokens whole on every
    rank: each rank looks the ids up in its own shard of the table
    (``to_local``), zeroes the rows of ids outside its vocab range, and
    the rows are summed over the mesh dims that shard the vocabulary:
    reduce-scattered along D where the table keeps D whole and D splits,
    else all-reduced (the looked-up rows move, not the table). A table
    sharded along D keeps its shard of D in the rows. The backward adds
    each rank's cotangent rows into its own vocab shard."""

    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.distributed.tensor import Shard

        from repro_torch.launch.steps import local_shape_and_offset
        mesh, pl = table.device_mesh, table.placements
        local = table.to_local()
        _, off = local_shape_and_offset(table.shape, mesh, pl)
        idx = tokens - off[0]
        miss = (idx < 0) | (idx >= local.shape[0])
        idx = idx.clamp(0, local.shape[0] - 1)
        rows = local[idx].masked_fill(miss[..., None], 0)
        nd = rows.ndim
        summed = [Partial() if p == Shard(0) else
                  Shard(nd - 1) if p == Shard(1) else Replicate() for p in pl]
        d_whole = Shard(1) not in pl
        out_pl = [(Shard(nd - 1) if d_whole and table.shape[1]
                   % mesh.size(i) == 0 else Replicate()) if p == Shard(0)
                  else q for i, (p, q) in enumerate(zip(pl, summed))]
        shape = (*tokens.shape, table.shape[1])
        out = DTensor.from_local(
            rows, mesh, summed, run_check=False, shape=torch.Size(shape),
            stride=tuple(math.prod(shape[d + 1:]) for d in range(nd)))
        ctx.save_for_backward(idx, miss)
        ctx.table = (mesh, pl, table.shape, table.stride(), local.shape)
        # the cotangent rows whole over the vocab's dims, each rank's D
        ctx.rows_pl = [Replicate() if p == Shard(0) else q
                       for p, q in zip(pl, summed)]
        return out.redistribute(mesh, out_pl)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        idx, miss = ctx.saved_tensors
        mesh, pl, shape, stride, local_shape = ctx.table
        g = g.redistribute(mesh, ctx.rows_pl).to_local()
        g = g.masked_fill(miss[..., None], 0)
        grad = g.new_zeros(local_shape).index_add_(
            0, idx.reshape(-1), g.reshape(-1, g.shape[-1]))
        return DTensor.from_local(grad, mesh, pl, run_check=False,
                                  shape=shape, stride=stride), None


def _layer_params(tree):
    """One layer's parameters at their point of use: cast to the compute
    dtype, then (DTensors on a pod mesh) gathered over the batch axes, the
    FSDP all-gather the reference's XLA makes after the cast, in bf16."""
    return tu.tree_map(L.fsdp_gathered, _cast_floating(tree))


# ---------------------------------------------------------------------------
# parameter layout and init
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: tuple
    fan_in: Optional[int]  # None: a constant, ``fill``
    fill: float = 0.0


def _period_kinds(cfg: ArchConfig):
    pat = cfg.layer_pattern
    n_full = cfg.num_layers // len(pat)
    return pat, n_full, pat[:cfg.num_layers % len(pat)]


def _ffn_layout(cfg: ArchConfig, w) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    gated = cfg.ffn_type in ("silu", "geglu")
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        ffn = {"router": w(d, d, e), "experts_wo": w(f, e, f, d),
               "experts_wi_up": w(d, e, d, f)}
        if gated:
            ffn["experts_wi_gate"] = w(d, e, d, f)
        return ffn
    ffn = {"wo": w(f, f, d), "wi_up": w(d, d, f)}
    if gated:
        ffn["wi_gate"] = w(d, d, f)
    return ffn


def _layer_layout(cfg: ArchConfig, lead: tuple, kind: str) -> dict:
    """One layer of ``kind``: the reference's ``_init_layer`` leaves."""
    d, hd = cfg.d_model, cfg.head_dim
    w = lambda fan_in, *s: _Leaf(lead + s, fan_in)  # noqa: E731
    c = lambda fill, *s: _Leaf(lead + s, None, fill)  # noqa: E731
    out = {"norm": c(0.0, d), "ffn_norm": c(0.0, d),
           "ffn": _ffn_layout(cfg, w)}
    def attn(cross=False):
        a = {"wq": w(d, d, cfg.q_dim), "wk": w(d, d, cfg.kv_dim),
             "wv": w(d, d, cfg.kv_dim), "wo": w(cfg.q_dim, cfg.q_dim, d)}
        if cfg.qk_norm and not cross:
            a.update(q_norm=c(0.0, hd), k_norm=c(0.0, hd))
        return a

    if kind in ("attn", "swa") or (kind == "xattn"
                                   and cfg.family == "audio"):
        out["attn"] = attn()
    if kind == "xattn":  # cross-attention takes no qk-norm
        out["xattn"] = attn(cross=True)
        if cfg.family == "vlm":
            out["xattn"]["gate"] = c(0.0, 1)
        out["xnorm"] = c(0.0, d)
    elif kind == "rglru":
        out["rec"] = {"w_x": w(d, d, d), "w_gate": w(d, d, d),
                      "w_out": w(d, d, d),
                      "conv_w": w(L.RGLRU_CONV, L.RGLRU_CONV, d),
                      "w_rec": w(d, d, d), "w_inp": w(d, d, d),
                      "lam": c(0.5, d)}
    elif kind == "rwkv":
        H, r = cfg.num_heads, L.RWKV_LORA
        out["mix"] = {**{f"mu_{n}": c(0.5, d) for n in "rkvw"},
                      **{f"w_{n}": w(d, d, H * hd) for n in "rkv"},
                      "w_o": w(H * hd, H * hd, d), "w0": c(-1.0, d),
                      "w_lora_a": w(d, d, r), "w_lora_b": w(r, r, d),
                      "u": c(0.0, H, hd)}
    return out


def param_layout(cfg: ArchConfig) -> dict:
    """The parameter tree with each leaf's shape (and init fan-in or
    constant)."""
    _check_runs(cfg)
    pat, n_full, rem = _period_kinds(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    out = {"embed": _Leaf((v, d), d),
           "blocks": {f"l{i}": _layer_layout(cfg, (n_full,), kind)
                      for i, kind in enumerate(pat)},
           "final_norm": _Leaf((d,), None), "head": _Leaf((d, v), d)}
    if rem:
        out["rem_blocks"] = {f"l{i}": _layer_layout(cfg, (), kind)
                             for i, kind in enumerate(rem)}
    if cfg.encoder_layers:
        out["encoder"] = {
            "blocks": _layer_layout(cfg, (cfg.encoder_layers,), "attn"),
            "final_norm": _Leaf((d,), None)}
    return out


def _init_leaf(leaf: _Leaf, dtype, generator, device) -> torch.Tensor:
    if leaf.fan_in is None:
        return torch.full(leaf.shape, leaf.fill, dtype=dtype, device=device)
    t = torch.randn(leaf.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return t.mul_(leaf.fan_in ** -0.5).to(dtype)


def init_leaves(cfg: ArchConfig, generator: torch.Generator, device=None):
    """``init_params``' leaves one at a time, in flatten (sorted-key)
    order, with the same values: a caller can store each in another form
    before the next is drawn (the generator keeps no reference to it)."""
    dtype = getattr(torch, cfg.param_dtype)
    for leaf in tu.leaves(param_layout(cfg)):
        yield _init_leaf(leaf, dtype, generator, device)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> dict:
    """N(0, 1/fan_in) weights and the reference's constants (zero norm
    scales, RG-LRU's lam 0.5, RWKV's mixes 0.5 and w0 -1) in
    ``cfg.param_dtype``, drawn leaf by leaf (sorted-key order) from
    ``generator``, which must live on ``device``. The values are not the
    JAX package's (different generators); tests carry JAX parameters
    across instead."""
    treedef = tu.flatten(param_layout(cfg))[1]
    return tu.unflatten(treedef, list(init_leaves(cfg, generator, device)))


def serving_cast(params: dict) -> dict:
    """Each leaf of a draw with the values every cast point of the
    reference would give it: float leaves to bf16, except ``final_norm``
    (kept as it is: prefill reads it uncast, decode casts it itself) and
    the encoder's ``final_norm`` (read uncast). Works on (K, ...) stacked
    draws and on meta tensors."""
    out = _cast_floating({k: v for k, v in params.items()
                          if k != "final_norm"})
    out["final_norm"] = params["final_norm"]
    if "encoder" in params:
        out["encoder"]["final_norm"] = params["encoder"]["final_norm"]
    return out


def serving_params(params: dict) -> dict:
    """Cast a draw once for serving (``serving_cast``), with the head held
    as ``head_f32``: its bf16 values widened to fp32, so the logits
    product runs in fp32 without widening it on every call. Works on (K,
    ...) stacked draws; a tree already cast is returned as is."""
    if "head_f32" in params:
        return params
    out = serving_cast(params)
    out["head_f32"] = out.pop("head").to(torch.float32)
    return out


def _logits(x: torch.Tensor, params: dict) -> torch.Tensor:
    """(..., D) bf16 activations times the bf16 head, products and sums
    in fp32."""
    return x.to(torch.float32) @ params["head_f32"]


def _layers(cfg: ArchConfig):
    """(group, period index or None, layer key, kind) of every layer in
    order: the stacked periods, then the remainder."""
    pat, n_full, rem = _period_kinds(cfg)
    for i in range(n_full):
        for j, kind in enumerate(pat):
            yield "blocks", i, f"l{j}", kind
    for j, kind in enumerate(rem):
        yield "rem_blocks", None, f"l{j}", kind


def _take(tree: dict, group: str, i: Optional[int], key: str):
    """One layer's subtree; for stacked periods, views into the stack
    (writes through them land in the stack)."""
    node = tree[group][key]
    return node if i is None else tu.tree_map(lambda t: t[i], node)


# ---------------------------------------------------------------------------
# layers (full sequence)
# ---------------------------------------------------------------------------

AttentionFn = Callable[..., torch.Tensor]


def _self_attn(x, p, cfg: ArchConfig, positions, *, window=None,
               causal=True, attention: AttentionFn = flash_attention):
    """Self-attention with implicit positions (prefill). Returns the
    residual output and the layer's roped k and its v, which the decode
    cache holds. ``attention`` is the flash-attention kernel's wrapper
    (its plain version for CPU tensors)."""
    B, S, _ = x.shape
    a = p["attn"]
    lay = L.attention_layout(x, cfg.num_heads, cfg.num_kv_heads)
    h = L.summed(L.rms_norm(x, p["norm"]), lay)
    pq, pkv = lay[:2] if lay else (None, None)
    q = L.placed(h @ a["wq"], pq).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = L.placed(h @ a["wk"], pkv).reshape(B, S, cfg.num_kv_heads,
                                           cfg.head_dim)
    v = L.placed(h @ a["wv"], pkv).reshape(B, S, cfg.num_kv_heads,
                                           cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, a["q_norm"])
        k = L.rms_norm(k, a["k_norm"])
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    o = L.attend(attention, q, k, v, lay, causal=causal, window=window)
    return x + L.merge_heads(o) @ a["wo"], k, v


def _cross_attn(x, p, cfg: ArchConfig, enc_out, gated: bool):
    """Cross-attention of the decoder stream x (B, S, D) to ``enc_out``
    (B, Te, D): q from x normed by ``xnorm``, k and v from ``enc_out``,
    every position 0 and no mask, through the plain
    ``layers.chunked_attention`` (the reference's pure-JAX scan, with its
    flash backward). Gated (vlm): the output is scaled by tanh(gate),
    taken in the gate's dtype (bf16 after the cast) as the reference
    does."""
    B, S, _ = x.shape
    Te = enc_out.shape[1]
    a = p["xattn"]
    lay = L.attention_layout(x, cfg.num_heads, cfg.num_kv_heads)
    h = L.summed(L.rms_norm(x, p["xnorm"]), lay)
    pq, pkv = lay[:2] if lay else (None, None)
    q = L.placed(h @ a["wq"], pq).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = L.placed(enc_out @ a["wk"], pkv).reshape(B, Te, cfg.num_kv_heads,
                                                 cfg.head_dim)
    v = L.placed(enc_out @ a["wv"], pkv).reshape(B, Te, cfg.num_kv_heads,
                                                 cfg.head_dim)
    qpos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((B, Te), dtype=torch.int32, device=x.device)
    o = L.attend(L.chunked_attention, q, k, v, lay, q_positions=qpos,
                 kv_positions=kpos, causal=False)
    o = L.merge_heads(o) @ a["wo"]
    if gated:
        o = torch.tanh(a["gate"]).to(o.dtype) * o
    return x + o


def _attending(kind: str, x, p, cfg: ArchConfig, positions, enc_out,
               attention: AttentionFn):
    """An attending layer's sequence mixing over the full sequence ('attn',
    'swa', 'xattn'), before its FFN: (x, the self-attention's roped k and
    its v, or None for a vlm 'xattn' layer, which has none)."""
    k = v = None
    if kind != "xattn" or cfg.family == "audio":
        window = cfg.swa_window if kind == "swa" else None
        x, k, v = _self_attn(x, p, cfg, positions, window=window,
                             attention=attention)
    if kind == "xattn":
        x = _cross_attn(x, p, cfg, enc_out, gated=cfg.family == "vlm")
    return x, k, v


def _ffn_residual(x, p, cfg: ArchConfig):
    """The FFN's residual and its aux loss (fp32; 0 for a dense FFN). On a
    pod mesh its input is placed as the tensor-parallel FFN takes it:
    batch-sharded, replicated on 'model'."""
    h = L.shard_batch(L.rms_norm(x, p["ffn_norm"]))
    if cfg.moe is not None:
        y, aux = L.moe_ffn(h, p["ffn"], top_k=cfg.moe.top_k,
                           ffn_type=cfg.ffn_type,
                           capacity_factor=cfg.moe.capacity_factor)
        return x + y, aux
    return x + L.ffn_apply(h, p["ffn"], cfg.ffn_type), \
        x.new_zeros((), dtype=torch.float32)


def _recurrent(kind: str, x, p):
    """A recurrent layer ('rglru' or 'rwkv') over a full sequence: (the
    residual output, the layer's normed input, the state its forward ends
    in: RG-LRU's h_last, RWKV's {'S', 'x_prev'})."""
    h = L.rms_norm(x, p["norm"])
    if kind == "rglru":
        y, state = L.rglru_forward(h, p["rec"])
    else:
        y, state = L.rwkv_forward(h, p["mix"])
    return x + y, h, state


def _apply_layer(kind: str, x, p, cfg: ArchConfig, positions, enc_out,
                 attention: AttentionFn):
    """One layer of the training forward, its parameters already cast:
    (x, its aux loss)."""
    if kind in ("attn", "swa", "xattn"):
        x, _, _ = _attending(kind, x, p, cfg, positions, enc_out, attention)
    else:
        x, _, _ = _recurrent(kind, x, p)
    return _ffn_residual(x, p, cfg)


# ---------------------------------------------------------------------------
# training forward and log-likelihood
# ---------------------------------------------------------------------------

def _unbound(node: dict):
    """The layers of a stacked subtree, each leaf unbound once, so that
    its gradient is one stack of the layers' gradients, not a full-size
    scatter per layer."""
    leaves, treedef = tu.flatten(node)
    cols = [t.unbind(0) for t in leaves]
    return [tu.unflatten(treedef, [c[i] for c in cols])
            for i in range(leaves[0].shape[0])]


class _Recompute(torch.autograd.Function):
    """``body(*inputs)`` -> a tuple of tensors, keeping only ``inputs``
    for the backward, which runs ``body`` again and takes its vjp with
    ``torch.func.vjp`` (the reference's ``jax.checkpoint``). ``body``
    closes over what is not differentiated (the config, positions, the
    attention function); every tensor that may carry a gradient is an
    input. The backward runs under ``no_grad``, as the flash entry's does:
    ``torch.func.grad`` differentiates with ``create_graph=True``, and a
    recorded re-run would keep the body's residuals for a second
    derivative. Differentiable functions inside ``body`` (the flash entry,
    ``layers._RwkvScores``) nest: the re-run records them for the vjp.
    ``generate_vmap_rule`` lets the engine vmap it over chains."""
    generate_vmap_rule = True

    @staticmethod
    def forward(body, *inputs):
        return tuple(body(*inputs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.body = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        wrt = [i for i, t in enumerate(inputs)
               if t is not None and t.is_floating_point()]
        if any(L._dtensor(inputs[i]) is not None for i in wrt):
            return (None, *_recorded_vjp(ctx.body, inputs, wrt, grads))

        def f(*diff):
            args = list(inputs)
            for i, t in zip(wrt, diff):
                args[i] = t
            return tuple(ctx.body(*args))

        with torch.no_grad():
            _, vjp_fn = torch.func.vjp(f, *(inputs[i] for i in wrt))
            got = vjp_fn(grads)
        out = [None] * len(inputs)
        for i, g in zip(wrt, got):
            out[i] = g
        return (None, *out)


def _recorded_vjp(body: Callable, inputs, wrt, grads) -> list:
    """``_Recompute``'s backward for DTensor inputs (the dry run's): the
    body re-run under autograd, so that it sees the DTensors themselves
    (``torch.func``'s wrappers hide their placements from the anchors),
    and its vjp taken by ``torch.autograd.grad``."""
    args = list(inputs)
    for i in wrt:
        args[i] = inputs[i].detach().requires_grad_()
    with torch.enable_grad():
        outs = body(*args)
    pairs = [(o, g) for o, g in zip(outs, grads)
             if g is not None and o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], [args[i] for i in wrt],
                              [g for _, g in pairs], allow_unused=True)
    out = [None] * len(inputs)
    for i, g in zip(wrt, got):
        # an input the body does not reach gets zeros, as from a vjp
        out[i] = torch.zeros_like(inputs[i]) if g is None else g
    return out


def _checkpointed(body: Callable, x, tree, *extra, remat: bool = True):
    """``body(x, tree, *extra)`` -> tuple, through ``_Recompute`` when
    ``remat``: the tree's leaves and ``extra`` (tensors or None) are
    inputs of the recompute, so their gradients flow."""
    if not remat:
        return body(x, tree, *extra)
    leaves, treedef = tu.flatten(tree)
    n = len(leaves)

    def flat(x, *rest):
        return body(x, tu.unflatten(treedef, list(rest[:n])), *rest[n:])

    return _Recompute.apply(flat, x, *leaves, *extra)


def _positions(x: torch.Tensor) -> torch.Tensor:
    """(B, S) implicit positions of x (B, S, D). A recomputed body makes
    its own: a tensor made under a transform outside it cannot be read by
    its backward's re-run."""
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def _encoder_layer(x, p, cfg: ArchConfig, attention):
    """One encoder layer: bidirectional self-attention over the frames,
    then the FFN, its parameters cast to bf16 here."""
    p = _layer_params(p)
    x, _, _ = _self_attn(x, p, cfg, _positions(x), causal=False,
                         attention=attention)
    return _ffn_residual(x, p, cfg)[:1]


def encoder_forward(params: dict, cfg: ArchConfig, enc_embeds: torch.Tensor,
                    *, attention: AttentionFn = flash_attention_diff):
    """The audio encoder over stubbed frame embeddings (B, T, D): per
    layer bidirectional self-attention with rope over the T frames (one
    ``attention`` call with ``causal=False``) and the FFN, each layer's
    parameters cast to bf16 at the point of use (each layer recomputed in
    the backward under ``cfg.remat``), then the encoder's ``final_norm``
    (uncast). Returns (B, T, D) bf16."""
    x = enc_embeds.to(ACT_DTYPE)

    def body(x, p):
        x, = _encoder_layer(_shard_batch(x), p, cfg, attention)
        return _shard_batch(x),

    for p in _unbound(params["encoder"]["blocks"]):
        x, = _checkpointed(body, x, p, remat=cfg.remat)
    return L.rms_norm(x, params["encoder"]["final_norm"])


def encoder_stream(params: dict, cfg: ArchConfig, enc_embeds, *,
                   attention: AttentionFn = flash_attention_diff):
    """``enc_out``, the stream the 'xattn' layers attend to: None for a
    family without one, the patches ``enc_embeds`` cast to bf16 (vlm),
    ``encoder_forward`` of the frames ``enc_embeds`` (audio)."""
    if cfg.family not in ENCODER_FAMILIES:
        return None
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) needs enc_embeds")
    if cfg.family == "vlm":
        return enc_embeds.to(ACT_DTYPE)
    return encoder_forward(params, cfg, enc_embeds, attention=attention)


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            enc_embeds: Optional[torch.Tensor] = None,
            attention: AttentionFn = flash_attention_diff):
    """tokens (B, S) integer -> (hidden states (B, S, D) before the head,
    the MoE aux loss summed over the layers (fp32; 0 without MoE)).
    ``enc_embeds``: the stubbed frontend's output (B, T_enc, D), image
    patches (vlm) or audio frames (audio), which those families need.
    Every layer's parameters are cast to bf16 at the point of use,
    ``final_norm`` is not; activations are bf16. ``attention`` (default:
    the differentiable flash entry) takes q, k, v with implicit
    positions: every self-attention, the encoder's included."""
    _check_runs(cfg)
    enc_out = encoder_stream(params, cfg, enc_embeds, attention=attention)
    x = _shard_batch(_embed(params["embed"], tokens).to(ACT_DTYPE))
    pat, n_full, rem = _period_kinds(cfg)

    def period(x, layers, enc_out, kinds=pat):
        """Layers of ``kinds`` in turn: (x, their summed aux loss)."""
        aux = x.new_zeros((), dtype=torch.float32)
        positions = _positions(x)
        for p, kind in zip(layers, kinds):
            x, a = _apply_layer(kind, x, _layer_params(p), cfg, positions,
                                enc_out, attention)
            aux = aux + a
        return x, aux

    def anchored(x, layers, enc_out):
        """A stacked period with its two ends anchored (inside the
        recomputed body, so that the backward's re-run sees the same
        placements); the remainder layers are not, as in the reference."""
        x, aux = period(_shard_batch(x), layers, enc_out)
        return _shard_batch(x), aux

    aux = x.new_zeros((), dtype=torch.float32)
    if n_full:
        stacks = [_unbound(params["blocks"][f"l{j}"])
                  for j in range(len(pat))]
        for i in range(n_full):
            x, a = _checkpointed(anchored, x, [s[i] for s in stacks],
                                 enc_out, remat=cfg.remat)
            aux = aux + a
    if rem:
        x, a = period(x, [params["rem_blocks"][f"l{j}"]
                          for j in range(len(rem))], enc_out, rem)
        aux = aux + a
    return L.rms_norm(x, params["final_norm"]), aux


def _rows(logits) -> list:
    """The placements of DTensor ``logits``' rows: the vocab's shard
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    vocab = Shard(logits.ndim - 1)
    return [Replicate() if p == vocab else p for p in logits.placements]


class _VocabSum(torch.autograd.Function):
    """x.sum(-1, keepdim=True) of a DTensor x whose vocab is sharded,
    placed as x's rows are (the partial sums all-reduced). The backward
    hands each rank its shard of the broadcast cotangent; DTensor's own
    would reduce-scatter the partial sum onto the batch, then gather the
    whole vocabulary back at the next product."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape, ctx.placements = x.shape, x.placements
        return x.sum(-1, keepdim=True).redistribute(x.device_mesh, _rows(x))

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.shape).redistribute(g.device_mesh,
                                                ctx.placements)


def _logsumexp(logits):
    """logsumexp over the last dim, kept. On a DTensor (the dry run's,
    its vocab sharded over 'model') it is taken as the max, then the sum
    of exponentials, each reduced across the vocab's shards (two small
    all-reduces), as XLA partitions it; DTensor's own logsumexp gathers
    the whole logits first."""
    if L._dtensor(logits) is None:
        return torch.logsumexp(logits, -1, keepdim=True)
    m = L.placed(logits.detach().amax(-1, keepdim=True), _rows(logits))
    return torch.log(_VocabSum.apply(torch.exp(logits - m))) + m


def _label_logits(logits, lab):
    """logits[..., lab.clamp_min(0)], kept. On a DTensor whose vocab is
    sharded it is a one-hot product over each rank's vocab shard, summed
    across the shards, as XLA partitions it; DTensor's own gather gathers
    the whole logits, and its backward scatters into zeros of the whole
    vocabulary."""
    idx = lab.clamp_min(0)[..., None]
    if L._dtensor(logits) is None:
        return torch.gather(logits, -1, idx)
    return _VocabSum.apply(logits * (idx == L.iota_like(logits, -1)))


def _chunk_log_lik(h, head, lab):
    """One chunk's summed log-likelihood (a one-tuple), the logits fp32
    products and sums of ``h`` and ``head`` widened to fp32."""
    logits = h.to(torch.float32) @ head.to(torch.float32)
    ll = (_label_logits(logits, lab) - _logsumexp(logits))[..., 0]
    return (torch.where(lab >= 0, ll, 0.0).sum(),)


def chunked_log_lik(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """sum_t log p(label_t | hidden_t) over sequence chunks, so no (B, S, V)
    logits exist at once; labels < 0 count nothing. ``head`` (D, V) is
    used widened to fp32 and the logits are fp32 products and sums (the
    reference's ``preferred_element_type=float32``). Each chunk is
    recomputed in the backward, always, as the reference checkpoints its
    chunk body: the backward keeps neither the fp32 logits nor the
    widened head."""
    tot = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, hidden.shape[1], chunk):
        ll, = _Recompute.apply(_chunk_log_lik, hidden[:, s0:s0 + chunk],
                               head, labels[:, s0:s0 + chunk])
        tot = tot + ll
    return tot


def log_lik_fn(params: dict, cfg: ArchConfig, batch: dict, *,
               attention: AttentionFn = flash_attention_diff
               ) -> torch.Tensor:
    """Total log-likelihood of a (mini)batch {'tokens', 'labels'} (B, S),
    with 'enc_embeds' for the vlm and audio families: the quantity whose
    gradient SGLD/DSGLD/FSGLD scale by N_s/(f_s m). The head enters in
    bf16, as in the reference, and the MoE router's load-balance loss as
    a regulariser, ``AUX_WEIGHT`` per token."""
    hidden, aux = forward(params, cfg, batch["tokens"],
                          enc_embeds=batch.get("enc_embeds"),
                          attention=attention)
    head = L.fsdp_gathered(params["head"].to(ACT_DTYPE))
    ll = chunked_log_lik(hidden, head, batch["labels"])
    return ll - AUX_WEIGHT * aux * batch["tokens"].numel()


# ---------------------------------------------------------------------------
# cache-populating prefill
# ---------------------------------------------------------------------------

def _fill_cache(kind: str, cfg: ArchConfig, cache: dict, k, v, positions):
    """Lay the prompt's k/v into one attention layer's cache exactly as
    decode would have written them (ring slots pos % W for 'swa')."""
    B, S = positions.shape
    if kind == "swa":
        W = cache["k"].shape[1]
        b = torch.arange(B, device=k.device)[:, None]
        pw = positions[:, -W:]
        slots = pw % W
        cache["k"][b, slots] = k[:, -W:]
        cache["v"][b, slots] = v[:, -W:]
        cache["pos"][b, slots] = pw.to(cache["pos"].dtype)
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["pos"][:, :S] = positions.to(cache["pos"].dtype)


def prefill_with_cache(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                       cache_len: int, *,
                       enc_embeds: Optional[torch.Tensor] = None,
                       enc_out: Optional[torch.Tensor] = None,
                       attention: AttentionFn = flash_attention):
    """Forward over the prompt AND build the decode cache in one pass.

    params: one draw cast by ``serving_params``; tokens (B, S) integer.
    The vlm and audio families take ``enc_embeds`` (as ``forward``), or
    ``enc_out``, the stream their 'xattn' layers attend to, already made
    from it (``encoder_forward``'s output for audio, the bf16 patches for
    vlm): a server that has encoded a request's frames hands them over
    instead of encoding them again. Returns (last-token logits (B, V)
    fp32, cache) where the cache has ``init_cache(cfg, B, cache_len)``'s
    layout and ``decode_step`` continues from position S. Each
    self-attention, the encoder's included, goes through ``attention``
    (default: the flash-attention kernel on CUDA, its plain version on
    the CPU). A recurrent layer's state is the one its forward ends in:
    for 'rglru' h and the last W-1 rows of the conv's input ``h @ w_x``
    (zero-padded), for 'rwkv' S and the normed input's last row. A vlm
    'xattn' layer's cache entry is empty; an audio one holds its
    self-attention's k/v.
    """
    _check_runs(cfg)
    B, S = tokens.shape
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    dev = tokens.device
    if enc_out is None:
        enc_out = encoder_stream(params, cfg, enc_embeds, attention=attention)
    x = _shard_batch(_embed(params["embed"], tokens).to(ACT_DTYPE))
    positions = torch.arange(S, device=dev).expand(B, S)
    last = f"l{len(cfg.layer_pattern) - 1}"
    cache = init_cache(cfg, B, cache_len, device=dev)
    for group, i, key, kind in _layers(cfg):
        p = _layer_params(_take(params, group, i, key))
        c = _take(cache, group, i, key)
        if kind in ("attn", "swa", "xattn"):
            x, k, v = _attending(kind, x, p, cfg, positions, enc_out,
                                 attention)
            if k is not None:
                _fill_cache(kind, cfg, c, k, v, positions)
        elif kind == "rglru":
            x, h, h_last = _recurrent(kind, x, p)
            W = p["rec"]["conv_w"].shape[0]
            xin = L.pad_front(h @ p["rec"]["w_x"], W - 1)
            c["h"].copy_(h_last)
            c["conv"].copy_(xin[:, -(W - 1):])
        else:
            x, _, state = _recurrent(kind, x, p)
            c["S"].copy_(state["S"])
            c["x_prev"].copy_(state["x_prev"])
        x, _ = _ffn_residual(x, p, cfg)
        if group == "blocks" and key == last:     # a period's output
            x = _shard_batch(x)
    x = L.rms_norm(x, params["final_norm"])
    return _logits(x[:, -1], params), cache


# ---------------------------------------------------------------------------
# decode (single-token serving step)
# ---------------------------------------------------------------------------

def _layer_cache(kind: str, cfg: ArchConfig, lead: tuple, batch: int,
                 seq_len: int, dtype, device):
    if kind == "xattn" and cfg.family == "vlm":
        return {}
    if kind == "rglru":
        return L.rglru_init_state(batch, cfg.d_model, L.RGLRU_CONV, dtype,
                                  lead=lead, device=device)
    if kind == "rwkv":
        return L.rwkv_init_state(batch, cfg.num_heads, cfg.head_dim,
                                 cfg.d_model, dtype, lead=lead,
                                 device=device)
    S = min(cfg.swa_window, seq_len) if kind == "swa" else seq_len
    kv = lead + (batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "pos": torch.full(lead + (batch, S), -1, dtype=torch.int32,
                              device=device)}


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=ACT_DTYPE,
               device=None) -> dict:
    """Empty decode cache, stacked over full periods like the parameters:
    per attention layer ('attn', an audio 'xattn' layer's self-attention)
    k/v (B, S, K, hd) and pos (B, S) = -1, S = seq_len ('attn') or
    min(window, seq_len) ('swa', a ring); a vlm 'xattn' layer {}; per
    'rglru' layer h (B, D) fp32 and the conv history (B, W-1, D); per
    'rwkv' layer S (B, H, hd, hd) fp32 and x_prev (B, D)."""
    _check_runs(cfg)
    pat, n_full, rem = _period_kinds(cfg)
    cache = {"blocks": {
        f"l{i}": _layer_cache(kind, cfg, (n_full,), batch, seq_len, dtype,
                              device) for i, kind in enumerate(pat)}}
    if rem:
        cache["rem_blocks"] = {
            f"l{i}": _layer_cache(kind, cfg, (), batch, seq_len, dtype,
                                  device) for i, kind in enumerate(rem)}
    return cache


def _update_kv(cache: dict, k_new, v_new, pos, ring: bool) -> None:
    """Write k_new/v_new (B, 1, K, hd) at each row's slot, in place (the
    reference returns an updated copy)."""
    B, S = cache["pos"].shape
    slot = pos % S if ring else torch.clamp_max(pos, S - 1)
    if L._dtensor(cache["k"]) is not None:
        # a pod mesh's cache may be sharded along the slots: each rank
        # writes the slots of its own shard (XLA's masked update)
        hit = slot[:, None] == L.iota_like(cache["pos"], 1)      # (B, S)
        for name, new in (("k", k_new), ("v", v_new)):
            cache[name].copy_(torch.where(hit[..., None, None], new,
                                          cache[name]))
        cache["pos"].copy_(torch.where(hit, pos[:, None].to(
            cache["pos"].dtype), cache["pos"]))
        return
    b = torch.arange(B, device=pos.device)
    cache["k"][b, slot] = k_new[:, 0]
    cache["v"][b, slot] = v_new[:, 0]
    cache["pos"][b, slot] = pos.to(cache["pos"].dtype)


def _decode_self_attn(x, p, cfg: ArchConfig, cache, pos, *, ring):
    B = x.shape[0]
    a = p["attn"]
    h = L.rms_norm(x, p["norm"])
    pl = L.decode_layout(cache["k"])
    q = L.placed(h @ a["wq"], pl).reshape(B, 1, cfg.num_heads, cfg.head_dim)
    k = L.placed(h @ a["wk"], pl).reshape(B, 1, cfg.num_kv_heads,
                                          cfg.head_dim)
    v = L.placed(h @ a["wv"], pl).reshape(B, 1, cfg.num_kv_heads,
                                          cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, a["q_norm"])
        k = L.rms_norm(k, a["k_norm"])
    q = L.rope(q, pos[:, None], cfg.rope_theta)
    k = L.rope(k, pos[:, None], cfg.rope_theta)
    _update_kv(cache, k.to(cache["k"].dtype), v.to(cache["v"].dtype), pos,
               ring)
    o = L.placed(L.decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                    pos), pl)
    return x + o.reshape(B, 1, -1) @ a["wo"]


def decode_step(params: dict, cfg: ArchConfig, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                enc_out: Optional[torch.Tensor] = None):
    """One serving step of a draw cast by ``serving_params``. token (B, 1)
    integer; pos (B,) absolute positions; ``enc_out`` the vlm / audio
    stream the 'xattn' layers attend to (their k and v are projected from
    it at every step). Returns (logits (B, V) fp32, cache), the cache
    updated in place: a stacked period's entries are views into the
    stack, so recurrent states are written with ``copy_``."""
    _check_runs(cfg)
    x = _embed(params["embed"], token[:, 0]).to(ACT_DTYPE)[:, None, :]
    if enc_out is not None:
        enc_out = enc_out.to(ACT_DTYPE)
    for group, i, key, kind in _layers(cfg):
        if group == "blocks" and key == "l0":     # a period's input
            x = _shard_batch(x)
        p = _layer_params(_take(params, group, i, key))
        c = _take(cache, group, i, key)
        if kind in ("attn", "swa"):
            x = _decode_self_attn(x, p, cfg, c, pos, ring=kind == "swa")
        elif kind == "xattn":
            if cfg.family == "audio":
                x = _decode_self_attn(x, p, cfg, c, pos, ring=False)
            x = _cross_attn(x, p, cfg, enc_out, gated=cfg.family == "vlm")
        else:
            h = L.rms_norm(x, p["norm"])
            step = L.rglru_decode if kind == "rglru" else L.rwkv_decode
            y, state = step(h, p["rec" if kind == "rglru" else "mix"], c)
            for name, t in state.items():
                c[name].copy_(t)
            x = x + y
        x, _ = _ffn_residual(x, p, cfg)
    x = L.rms_norm(x, params["final_norm"].to(ACT_DTYPE))
    return _logits(x[:, 0], params), cache


def broadcast_cache(cache: dict, k: int) -> dict:
    """Fan one prefilled decode cache out to K posterior draws: every leaf
    gains a leading draw axis (K, ...). The copies are materialised,
    because each draw's decode writes its own rows in place."""
    return tu.tree_map(
        lambda t: t[None].expand((k,) + tuple(t.shape)).clone(), cache)


def ensemble_decode_step(draws: dict, cfg: ArchConfig, caches: dict,
                         token: torch.Tensor, pos: torch.Tensor, *,
                         enc_out: Optional[torch.Tensor] = None):
    """One serving step across K posterior draws sharing ONE token stream:
    ``draws``/``caches`` carry a leading (K, ...) draw axis, ``token``
    (B, 1), ``pos`` (B,) and ``enc_out`` are shared. The draw axis is a
    loop over K (each draw's cache updated in place through views).
    Returns (logits (K, B, V), caches)."""
    n = tu.leaves(draws)[0].shape[0]
    logits = []
    for kk in range(n):
        lg, _ = decode_step(tu.tree_map(lambda t: t[kk], draws), cfg,
                            tu.tree_map(lambda t: t[kk], caches), token, pos,
                            enc_out=enc_out)
        logits.append(lg)
    return torch.stack(logits), caches
