"""Layer primitives of the decoder-only families (counterpart of
``repro.models.layers``): attention, the dense and MoE feed-forwards, the
RG-LRU recurrent block (recurrentgemma) and the RWKV-6 time mix.

Tensors keep the JAX package's layouts: activations (B, S, D), attention
(B, S, heads, hd), caches (B, S_cache, K, hd). Every sequence mixer has
two modes:

* full sequence (training, prefill): ``chunked_attention``, the plain
  block scan with explicit positions and the reference's flash backward
  (``kernels.flash_attention.attention_scan_bwd``, the port of
  ``_flash_bwd``), so it differentiates like the reference's
  ``jax.custom_vjp``; ``rglru_forward``, a log-depth scan of the linear
  recurrence; ``rwkv_forward``, the chunked linear-attention form;
* one token against a cache or recurrent state: ``decode_attention``,
  ``rglru_decode``, ``rwkv_decode``.

None of these blocks has a kernel of its own: they are plain PyTorch,
differentiated by autograd (RWKV's intra-chunk scores by a backward of
their own that recomputes the pairwise decays). Where the reference multiplies an fp32
activation by a bf16 parameter (JAX promotes the parameter), the port
widens the bf16 value with ``.float()``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import NEG_INF, scan_attention
from repro_torch.sharding.rules import local_shard


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# placements on a pod mesh (DTensors: the dry run's layouts). A plain
# tensor passes through every one of these unchanged.
# ---------------------------------------------------------------------------

def _dtensor(x):
    """x as a DTensor, or None for any other tensor."""
    if type(x) is torch.Tensor or not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor
    return x if isinstance(x, DTensor) else None


def shard_batch(x, batch: Optional[int] = None):
    """Anchor an activation's placement (the reference's ``_shard_batch``):
    a DTensor's dim 0 sharded over ('pod'?, 'data'), every other mesh dim
    replicated. Without it DTensor's propagation chooses placements op by
    op, and on the pod meshes replicates whole layers of compute across
    ranks and moves activations in their place. ``batch`` is the size
    those axes must divide (default dim 0's): a dim 0 that folds the
    batch with another dim is anchored only where the batch splits
    evenly. A plain tensor, a mesh without 'data' or a batch the axes do
    not divide: x unchanged. The mesh is the DTensor's own."""
    if _dtensor(x) is None:
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    baxes = [a for a in ("pod", "data") if a in names]
    size = math.prod(mesh.size(names.index(a)) for a in baxes)
    if not baxes or (x.shape[0] if batch is None else batch) % size:
        return x
    # redistributed even where it is placed so already: the backward then
    # places the cotangent alike, as the reference's constraint does
    return x.redistribute(mesh, [Shard(0) if n in baxes else Replicate()
                                 for n in names])


def summed(x, layout):
    """An attention's input x reduced where it holds a pending sum
    (``Partial``) on a mesh dim the attention shards (``layout``, of
    ``attention_layout``), placed as ``shard_batch`` places it; else x as
    it is. A matrix product of a partial operand is computed whole on
    every rank of that mesh dim (DTensor gathers the weight rather than
    reduce the activation): the projections then run replicated for an
    attention that is not. The reference's XLA reduces the sum first."""
    if layout is None or not any(p.is_partial() and q.is_shard()
                                 for p, q in zip(x.placements, layout[0])):
        return x
    return shard_batch(x)


def attention_layout(x, H: int, K: int):
    """How one attention's operands are placed on a pod mesh, so that the
    attention and its backward run on each rank's shard with no
    collective: (the placements of q (B, Sq, H, hd), those of k and v
    (B, Sk, K, hd), whether k and v are widened to H heads for the
    attention), or None for a plain activation x (B, ...). Each mesh dim
    in turn shards the batch while it divides evenly, else the query
    heads, else nothing; k and v shard the heads too where K divides, and
    are otherwise replicated there and widened (each KV head repeated
    over its group) just before the attention."""
    if _dtensor(x) is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    B = x.shape[0]
    pl_q, pl_kv, heads = [], [], 1
    for i in range(mesh.ndim):
        n = mesh.size(i)
        if B % n == 0:
            pl_q.append(Shard(0))
            pl_kv.append(Shard(0))
            B //= n
        elif H % (heads * n) == 0:
            heads *= n
            pl_q.append(Shard(2))
            pl_kv.append(Shard(2) if K % heads == 0 else Replicate())
        else:
            pl_q.append(Replicate())
            pl_kv.append(Replicate())
    return pl_q, pl_kv, pl_kv != pl_q


def attend(attention, q, k, v, layout, **kw):
    """``attention(q, k, v, **kw)`` with q, k, v placed by ``layout``
    (``attention_layout``; None: plain tensors, called as they are); the
    output's cotangent is placed as q is."""
    if layout is None:
        return attention(q, k, v, **kw)
    pl_q, _, widen = layout
    if widen:
        k, v = (t.repeat_interleave(q.shape[2] // t.shape[2], dim=2)
                for t in (k, v))
    q, k, v = (placed(t, pl_q) for t in (q, k, v))
    return placed(attention(q, k, v, **kw), pl_q)


def merge_heads(o):
    """o (B, S, H, hd) -> (B, S, H * hd). A DTensor's merged output is
    placed as it is (a no-op), so that the backward places the cotangent
    alike before splitting the heads again: a cotangent sharded along
    H * hd where the heads do not split that mesh dim (whisper's 20,
    recurrentgemma's 10 on 16 ranks) cannot be split into (H, hd)
    without a redistribution, which torch 2.11's view rule refuses."""
    x = o.reshape(o.shape[0], o.shape[1], -1)
    return x if _dtensor(x) is None else x.redistribute(x.device_mesh,
                                                        x.placements)


def placed(x, pl):
    """x redistributed to placements ``pl`` (None: x as it is). Where x is
    placed so already, the backward still places x's cotangent as ``pl``
    says."""
    return x if pl is None else x.redistribute(x.device_mesh, pl)


def unsharded(t, dim: int):
    """DTensor t with dim ``dim`` whole on every rank (its shards
    gathered); anything else as it is."""
    if _dtensor(t) is None:
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim %= t.ndim
    return t.redistribute(t.device_mesh, [
        Replicate() if p == Shard(dim) else p for p in t.placements])


def iota_like(t, dim: int):
    """arange(t.shape[dim]) as a DTensor placed as DTensor t's dim ``dim``
    is: a rank holds the indices of its own shard of that dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim %= t.ndim
    mesh = t.device_mesh
    iota = DTensor.from_local(
        torch.arange(t.shape[dim], device=t.to_local().device), mesh,
        [Replicate()] * mesh.ndim, run_check=False)
    return iota.redistribute(mesh, [Shard(0) if p == Shard(dim)
                                    else Replicate() for p in t.placements])


def decode_layout(k_cache):
    """The placements of a decode step's projections (B, 1, N) and of its
    attention's output (B, 1, H, hd) on a pod mesh, from its cache's (B,
    S, K, hd): the batch where the cache shards it, the heads where the
    cache shards its KV heads, replicated elsewhere (a cache sharded
    along its sequence is read by each rank's whole query). None for a
    plain cache."""
    if _dtensor(k_cache) is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    return [p if p in (Shard(0), Shard(2)) else Replicate()
            for p in k_cache.placements]


def fsdp_gathered(w):
    """A DTensor weight gathered over the batch axes ('pod', 'data'), its
    other placements kept: the FSDP all-gather the reference's XLA makes
    at a weight's point of use (the backward reduce-scatters its
    gradient)."""
    if _dtensor(w) is None:
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names or ()
    return w.redistribute(w.device_mesh, [
        Replicate() if n in ("pod", "data") else p
        for n, p in zip(names, w.placements)])


def _off_sequence(t) -> list:
    """The placements of a DTensor (B, S, H, hd) whose sequence dim is
    whole on every rank: a shard of it moves to the heads where they
    divide that mesh dim (an all-to-all), else is gathered. The RWKV chunk
    loop walks the sequence, as the reference's scan over chunks does."""
    from torch.distributed.tensor import Replicate, Shard
    pl = list(t.placements)
    for i, p in enumerate(pl):
        if p == Shard(1):
            heads = t.shape[2] % t.device_mesh.size(i) == 0 \
                and Shard(2) not in pl
            pl[i] = Shard(2) if heads else Replicate()
    return pl


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor,
                      kv_positions: torch.Tensor, causal: bool = True,
                      window: Optional[int] = None,
                      block_k: int = 512) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a scan over KV blocks with
    running max / normaliser (the reference's ``_flash_fwd_scan``), whose
    gradient is the reference's flash backward (residuals q, k, v, m,
    l; per-block probabilities recomputed). q (B, Sq, H, hd), k/v
    (B, Sk, K, hd) with H % K == 0 (KV heads expanded per block);
    positions (B, Sq) and (B, Sk), -1 marking empty key slots."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not split into "
                         f"{k.shape[2]} KV heads")
    return scan_attention(q, k, v, q_positions, kv_positions, causal=causal,
                          window=window, block_k=block_k)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     q_position: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffer) cache, in fp32.
    q (B, 1, H, hd); caches (B, S, K, hd); kv_positions (B, S) with -1
    for empty slots; q_position (B,). A DTensor cache is attended on each
    rank's own shards (``_local_decode``)."""
    if _dtensor(k_cache) is not None:
        return _local_decode(q, k_cache, v_cache, kv_positions, q_position)
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg,
                     k_cache.to(torch.float32)) * hd ** -0.5
    valid = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _local_decode(q, k_cache, v_cache, kv_positions, q_position):
    """``decode_attention`` of DTensors on each rank's own shards of the
    cache: every product is independent per (row, head), so it runs on
    local tensors, as XLA runs the reference's, and the output is wrapped
    back placed as ``decode_layout`` says. (DTensor would flatten the
    sharded batch and head dims into one in the einsums' batched
    products, which torch 2.11's view rule refuses.)

    Where the cache's slots are sharded, the softmax is split across the
    slot shards instead of gathering the scores: each rank takes its
    shard's row max, all-reduced (max) over the mesh dims that shard the
    slots, then exp(s - m), its sum and the unnormalised p @ v, both
    all-reduced (sum), and divides. A row with no valid slot on a rank
    contributes exp(NEG_INF - m) = 0 there; one with none anywhere has m
    = NEG_INF, every exp(0) = 1, and gives the plain softmax's uniform
    weights."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = k_cache.device_mesh
    pl = decode_layout(k_cache)
    cache_pl = [p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
                for p in k_cache.placements]
    q_l = local_shard(q, mesh, pl)
    k_l, v_l = (local_shard(t, mesh, cache_pl) for t in (k_cache, v_cache))
    pos_l = local_shard(kv_positions, mesh, [
        p if p in (Shard(0), Shard(1)) else Replicate() for p in cache_pl])
    qp_l = local_shard(q_position, mesh, [
        p if p == Shard(0) else Replicate() for p in pl])
    slots = [i for i, p in enumerate(cache_pl) if p == Shard(1)]
    if not slots:
        out = decode_attention(q_l, k_l, v_l, pos_l, qp_l)
    else:
        out = _split_softmax_decode(q_l, k_l, v_l, pos_l, qp_l, mesh, slots)
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=q.shape,
                              stride=tuple(math.prod(q.shape[d + 1:])
                                           for d in range(q.ndim)))


def _split_softmax_decode(q, k_cache, v_cache, kv_positions, q_position,
                          mesh, slots):
    """Local tensors' ``decode_attention`` with the softmax over the slots
    reduced across the mesh dims ``slots`` (``_local_decode``). The sum
    and the output travel in one all-reduce per mesh dim."""
    import torch.distributed._functional_collectives as funcol
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    qg = q.reshape(B, K, H // K, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg,
                     k_cache.to(torch.float32)) * hd ** -0.5
    valid = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)                              # (B, K, G, 1)
    for i in slots:
        m = funcol.all_reduce(m, "max", (mesh, i))
    e = torch.exp(s - m)
    o = torch.cat([torch.einsum("bkgs,bskh->bkgh", e,
                                v_cache.to(torch.float32)),
                   e.sum(-1, keepdim=True)], dim=-1)          # (B, K, G, hd+1)
    for i in slots:
        o = funcol.all_reduce(o, "sum", (mesh, i))
    out = o[..., :-1] / o[..., -1:]
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# feed-forward (dense + MoE)
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, x * sigmoid(x), as its formula: ``F.silu``'s
    fused backward gives other roundings under ``torch.func.grad`` than
    inside a recomputed body's vjp, so a recomputed pass would not be
    bitwise the pass it replaces."""
    return x * torch.sigmoid(x)


def ffn_apply(x: torch.Tensor, p: dict, ffn_type: str) -> torch.Tensor:
    """Dense FFN."""
    if ffn_type == "silu":
        h = _silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    elif ffn_type == "geglu":
        h = _gelu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    elif ffn_type == "gelu":
        h = _gelu(x @ p["wi_up"])
    else:
        raise ValueError(f"unknown ffn_type {ffn_type!r}")
    return h @ p["wo"]


def _experts(h: torch.Tensor, p: dict, ffn_type: str) -> torch.Tensor:
    """Every expert's FFN on its own rows: h (E, R, D) -> (E, R, D)."""
    if ffn_type in ("silu", "geglu"):
        act = _silu if ffn_type == "silu" else _gelu
        hh = act(h @ p["experts_wi_gate"]) * (h @ p["experts_wi_up"])
    elif ffn_type == "gelu":
        hh = _gelu(h @ p["experts_wi_up"])
    else:
        raise ValueError(f"unknown ffn_type {ffn_type!r}")
    return hh @ p["experts_wo"]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of integer or integral-float ``idx`` (all zeros where
    idx is outside [0, n)), by comparison with arange: ``F.one_hot`` is
    not vmappable under ``torch.func`` on every version."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _capacity(tokens: int, top_k: int, experts: int,
              capacity_factor: float) -> int:
    return max(top_k, int(math.ceil(tokens * top_k / experts
                                    * capacity_factor)))


def _moe_group(x: torch.Tensor, p: dict, *, top_k: int, ffn_type: str,
               capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based top-k dispatch for one token group, the reference's
    dense-routing oracle (its tests hold ``_moe_dense_dispatch`` against
    it). x (T, D) -> ((T, D), the Switch aux loss). Slots past an
    expert's capacity go to an overflow row and contribute zero."""
    T, D = x.shape
    E = p["experts_wo"].shape[0]
    gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top_w, top_i = torch.topk(gates, top_k, dim=-1)           # (T, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    density = _one_hot(top_i[:, 0], E).mean(0)
    aux = E * (density * gates.mean(0)).sum()
    cap = _capacity(T, top_k, E, capacity_factor)

    slot_e = top_i.reshape(-1)                                # (T*k,)
    slot_w = top_w.reshape(-1)
    slot_t = torch.arange(T * top_k, device=x.device) // top_k
    order = torch.argsort(slot_e, stable=True)
    sorted_e = slot_e[order]
    counts = torch.bincount(slot_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * top_k, device=x.device) - starts[sorted_e]
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank, E * cap)  # overflow row
    buf = x.new_zeros((E * cap + 1, D)).index_put((dest,), x[slot_t[order]])
    out = _experts(buf[:E * cap].reshape(E, cap, D), p, ffn_type)
    out = torch.cat([out.reshape(E * cap, D), out.new_zeros((1, D))])
    gathered = out[dest] * (slot_w[order] * keep)[:, None].to(x.dtype)
    y = x.new_zeros((T, D)).index_add(0, slot_t[order], gathered)
    return y, aux


def _moe_dense_dispatch(x: torch.Tensor, p: dict, *, top_k: int,
                        ffn_type: str, capacity_factor: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard routing by one-hot products: x (G, Tg, D) token groups ->
    ((G, Tg, D), the Switch aux loss from the first choice).

    Iterative top-k: each round takes every token's best remaining
    expert, its position in that expert's queue (cumsum over the group
    plus the earlier rounds' counts) and keeps it below the capacity
    ``max(top_k, ceil(Tg * top_k / E * capacity_factor))``. ``dispatch``
    (G, Tg, E, cap) is in the activation dtype; ``combine`` is fp32,
    normalised by the kept weight, and cast to the activation dtype
    before the last product. The router product is bf16 x bf16 with fp32
    products and sums (widened operands: their products are exact)."""
    G, Tg, D = x.shape
    E = p["experts_wo"].shape[0]
    cap = _capacity(Tg, top_k, E, capacity_factor)
    gates = torch.softmax(x.float() @ p["router"].to(x.dtype).float(),
                          dim=-1)                             # (G, Tg, E)
    remaining = gates
    count = gates.new_zeros((G, 1, E))
    dispatch = x.new_zeros((G, Tg, E, cap))
    combine = gates.new_zeros((G, Tg, E, cap))
    weight_sum = gates.new_zeros((G, Tg, 1))
    first = None
    for _ in range(top_k):
        onehot = _one_hot(torch.argmax(remaining, dim=-1), E)  # (G, Tg, E)
        w = (gates * onehot).sum(-1, keepdim=True)            # (G, Tg, 1)
        pos = torch.cumsum(onehot, dim=1) - onehot + count
        pos = (pos * onehot).sum(-1)                          # (G, Tg)
        keep = (pos < cap).to(torch.float32)[..., None]
        d = (onehot * keep)[..., None] * _one_hot(pos, cap)[:, :, None, :]
        dispatch = dispatch + d.to(x.dtype)
        combine = combine + d * w[..., None]
        weight_sum = weight_sum + w * keep
        count = count + (onehot * keep).sum(1, keepdim=True)
        remaining = remaining * (1.0 - onehot)
        first = onehot if first is None else first
    combine = combine / torch.clamp_min(weight_sum, 1e-9)[..., None]
    aux = E * (first.mean((0, 1)) * gates.mean((0, 1))).sum()

    # (G, E*cap, D): each expert's slots, gathered from the group's tokens
    h = dispatch.reshape(G, Tg, E * cap).transpose(1, 2) @ x
    h = h.reshape(G, E, cap, D).transpose(0, 1).reshape(E, G * cap, D)
    out = _experts(h, p, ffn_type).reshape(E, G, cap, D)
    out = out.transpose(0, 1).reshape(G, E * cap, D)
    y = combine.to(x.dtype).reshape(G, Tg, E * cap) @ out
    return y, aux


MOE_GROUP_SIZE = 512


def moe_ffn(x: torch.Tensor, p: dict, *, top_k: int, ffn_type: str,
            capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> ((B, S, D), aux loss). Tokens are grouped into
    contiguous chunks of ``MOE_GROUP_SIZE`` per batch row (halved until
    the group divides S); routing capacity is per group."""
    B, S, D = x.shape
    g = min(MOE_GROUP_SIZE, S)
    while S % g:
        g //= 2
    y, aux = _moe_dense_dispatch(x.reshape(B * (S // g), g, D), p,
                                 top_k=top_k, ffn_type=ffn_type,
                                 capacity_factor=capacity_factor)
    # the groups placed by batch row first: a view cannot unflatten the
    # group dim where DTensor has sharded it another way
    return shard_batch(y, B).reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / recurrentgemma)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0
RGLRU_CONV = 4  # the causal conv's width


def _rglru_gates(xc: torch.Tensor, p: dict):
    """xc fp32 (B, S, D) -> the recurrence's (a, b), fp32. The gate
    weights enter widened from their (bf16) values; softplus(lam) is taken
    in lam's dtype, as the reference's promotion does."""
    r = torch.sigmoid(xc @ p["w_rec"].float())               # recurrence gate
    i = torch.sigmoid(xc @ p["w_inp"].float())               # input gate
    log_a = (-_RGLRU_C * F.softplus(p["lam"])).float() * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xc)
    return a, gated


def pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B, S, ...) with n zero rows in front along dim 1: a cat, since
    torch 2.11's DTensor rule for ``F.pad`` fails on a pod mesh."""
    return torch.cat([torch.zeros_like(x[:, :1])] * n + [x], dim=1)


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width w.shape[0]: x (B, S, D), w (W, D)
    (on sequence shards: ``_SeqShards.conv``)."""
    return _conv_taps(pad_front(x, w.shape[0] - 1), w, x)


def _conv_taps(xp: torch.Tensor, w: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """The conv of x from xp, x led by its W - 1 rows before."""
    S = x.shape[1]
    out = torch.zeros_like(x)
    for t in range(w.shape[0]):
        out = out + xp[:, t:t + S] * w[t]
    return out


def _hillis_steele(a: torch.Tensor, b: torch.Tensor):
    """(prod_{s<=t} a_s, h_t) along dim 1, h_t = a_t h_{t-1} + b_t from
    h_{-1} = 0: ceil(log2 S) rounds of elementwise products, each
    composing every position with the one ``d`` earlier ((a_l, b_l) then
    (a_r, b_r) is (a_l a_r, b_l a_r + b_r))."""
    S, d = a.shape[1], 1
    while d < S:
        a_prev = torch.cat([torch.ones_like(a[:, :d]), a[:, :-d]], dim=1)
        b_prev = torch.cat([torch.zeros_like(b[:, :d]), b[:, :-d]], dim=1)
        a, b = a_prev * a, b_prev * a + b
        d *= 2
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, as a
    Hillis-Steele scan (``_hillis_steele``). No closed form through
    cumsum(log a): that underflows within tens of tokens."""
    return _hillis_steele(a, b)[1]


class _SeqShards:
    """RG-LRU on each rank's own shard of a DTensor (B, S, D) whose
    sequence is sharded (DTensor's placement of the pod meshes' prefill
    and training): the conv, the scan and the channel-wise ops run on
    local tensors, and only what crosses a shard boundary travels: the
    W - 1 rows before each shard (the conv's halo) and each shard's
    (prod a, h) at its end (the scan's carry), each all-gathered over the
    mesh dims that shard the sequence, (n_shards, B, ., D) where a
    gather of the sequence or an all-to-all would move (B, S, D). The
    reference's ``associative_scan`` is channel-wise alike."""

    def __init__(self, t):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh = t.device_mesh
        self.pl = [p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
                   for p in t.placements]
        self.seq = [i for i, p in enumerate(self.pl) if p == Shard(1)]
        self.channels_whole = Shard(2) not in self.pl
        n, c = 1, 0
        for i in self.seq:        # the shard's place along the sequence
            n *= self.mesh.size(i)
            c = c * self.mesh.size(i) + self.mesh.get_local_rank(i)
        self.n, self.index = n, c

    @classmethod
    def of(cls, t):
        """The sequence shards of DTensor t, or None (a plain tensor, or a
        sequence whole on every rank)."""
        if _dtensor(t) is None:
            return None
        from torch.distributed.tensor import Shard
        return cls(t) if Shard(1) in t.placements else None

    def channels(self, dim: int, rows: bool = False) -> list:
        """The placements of a tensor whose dim ``dim`` is the channels
        (D), sharded where the (B, S, D) tensors shard theirs; with
        ``rows`` its dim 0 is the batch, sharded alike (a state (B, D))."""
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(dim) if p == Shard(2) else
                p if rows and p == Shard(0) else Replicate()
                for p in self.pl]

    def local(self, t):
        return local_shard(t, self.mesh, self.pl)

    def operand(self, t, pl):
        """This rank's shard of t placed by ``pl``, an operand of the
        local (B, S, D) shards: replicated where those are sharded, so
        its gradient is partial there."""
        return local_shard(t, self.mesh, pl, partial=[
            i for i, (p, q) in enumerate(zip(self.pl, pl))
            if p.is_shard() and not q.is_shard()])

    def placed(self, t):
        """Local (B, S_l, D_l) shards as the global DTensor."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, self.pl, run_check=False)

    def gathered(self, t):
        """Local (B_l, ..., D_l) from every sequence shard: (n, B_l, ...,
        D_l) in sequence order (the sequence's mesh dims in mesh order,
        as DTensor nests them). Each rank reads its own part of it, so
        the gradient is partial there: the backward reduce-scatters."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        lead = [Shard(0) if p == Shard(1) else
                Shard(1) if p == Shard(0) else
                Shard(t.ndim) if p == Shard(2) else Replicate()
                for p in self.pl]
        dt = DTensor.from_local(t[None], self.mesh, lead, run_check=False)
        return dt.redistribute(self.mesh, [
            Replicate() if i in self.seq else p
            for i, p in enumerate(lead)]).to_local(grad_placements=[
                Partial() if i in self.seq else p
                for i, p in enumerate(lead)])

    def conv(self, x, w):
        """``_causal_conv1d`` of local shards x (B_l, S_l, D_l), w (W,
        D_l), each shard led by the W - 1 rows before it."""
        xp = torch.cat([self.halo(x[:, -(w.shape[0] - 1):]), x], dim=1)
        return _conv_taps(xp, w, x)

    def halo(self, tail):
        """tail (B_l, W - 1, D_l), each shard's last rows: the rows before
        this rank's shard (zeros before the first)."""
        tails = self.gathered(tail)
        return torch.cat([torch.zeros_like(tails[:1]), tails[:-1]])[
            self.index]

    def scan(self, a, b, h0):
        """The scan of local shards a, b (B_l, S_l, D_l) from h0 (B_l,
        D_l) or None: h (B_l, S_l, D_l). Each shard scans its own rows;
        the carry of the shards before it enters as prod a * carry. Every
        rank computes every shard's carry and selects its own, so that
        all run the same ops, forward and backward (a collective in the
        backward runs only where the gradient reaches it)."""
        a_cum, h = _hillis_steele(a, b)
        ends = self.gathered(torch.stack([a_cum[:, -1], h[:, -1]], 1))
        carries = [torch.zeros_like(h[:, 0]) if h0 is None else h0.float()]
        for j in range(self.n - 1):
            carries.append(ends[j, :, 0] * carries[-1] + ends[j, :, 1])
        return h + a_cum * torch.stack(carries)[self.index][:, None]

    def last(self, h, pl):
        """The sequence's last row of local h (B_l, S_l, D_l), a DTensor
        (B, D) placed by ``pl``: the last shard's row, summed over the
        sequence's mesh dims (zeros on every other shard)."""
        from torch.distributed.tensor import DTensor, Partial
        row = h[:, -1] * float(self.index == self.n - 1)
        return DTensor.from_local(row, self.mesh, [
            Partial() if i in self.seq else p for i, p in enumerate(pl)],
            run_check=False).redistribute(self.mesh, pl)

    def block(self, x, p, h0):
        """``rglru_forward`` of DTensor x (B, S, D) whose sequence is
        sharded and whose channels are whole, on the local shards: the
        projections are per token, so each rank runs them on its own rows
        with the weights whole (gathered over the mesh dims that shard
        them), and only the conv's halo and the scan's carries cross the
        shards. (torch 2.11's DTensor refuses the view a matrix product
        of such an x makes.)"""
        from torch.distributed.tensor import Replicate
        whole = [Replicate()] * self.mesh.ndim
        w = {k: self.operand(v, whole) for k, v in p.items()}
        state = self.channels(1, rows=True)
        x = self.local(x)
        xin = x @ w["w_x"]
        gate = _gelu(x @ w["w_gate"])
        a, b = _rglru_gates(self.conv(xin, w["conv_w"]).float(), w)
        h = self.scan(a, b, None if h0 is None else self.operand(h0, state))
        y = (h.to(x.dtype) * gate) @ w["w_out"]
        return self.placed(y), self.last(h, state)


def rglru_forward(x: torch.Tensor, p: dict,
                  h0: Optional[torch.Tensor] = None):
    """Griffin recurrent block over a full sequence. x (B, S, D); h0
    (B, D) a carried state or None. Returns (y (B, S, D), h_last (B, D)
    fp32). A DTensor x whose sequence is sharded runs on its local shards
    (``_SeqShards.block``); where only a and b come out so, the scan does
    (``_SeqShards.scan``)."""
    seq = _SeqShards.of(x)
    if seq is not None and seq.channels_whole:
        return seq.block(x, p, h0)
    xin = x @ p["w_x"]
    gate = _gelu(x @ p["w_gate"])
    xc = _causal_conv1d(xin, p["conv_w"])
    a, b = _rglru_gates(xc.float(), p)
    seq = _SeqShards.of(a)
    if seq is not None:
        state = seq.channels(1, rows=True)
        h = seq.scan(seq.local(a), seq.local(b),
                     None if h0 is None else seq.operand(h0, state))
        y = (seq.placed(h).to(x.dtype) * gate) @ p["w_out"]
        return y, seq.last(h, state)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = linear_scan(a, b)
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y, h[:, -1]


def rglru_decode(x: torch.Tensor, p: dict, state: dict):
    """One step. x (B, 1, D); state {'h': (B, D) fp32, 'conv': (B, W-1,
    D)}. Returns (y (B, 1, D), the new state)."""
    xin = x @ p["w_x"]
    gate = _gelu(x @ p["w_gate"])
    hist = torch.cat([state["conv"], xin], dim=1)            # (B, W, D)
    xc = (hist * p["conv_w"]).sum(1, keepdim=True)
    a, b = _rglru_gates(xc.float(), p)
    h = a[:, 0] * state["h"].float() + b[:, 0]
    y = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return y, {"h": h, "conv": hist[:, 1:]}


def rglru_init_state(batch: int, d: int, conv_width: int, dtype, *,
                     lead: tuple = (), device=None) -> dict:
    """Zero state, with ``lead`` axes in front (stacked periods)."""
    return {"h": torch.zeros(lead + (batch, d), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, conv_width - 1, d),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 time mix (chunked linear attention with data-dependent decay)
# ---------------------------------------------------------------------------

RWKV_LORA = 64  # rank of the decay's LoRA


def _rwkv_projections(x: torch.Tensor, p: dict, x_prev: torch.Tensor):
    """Token-shift mixes and the r/k/v/decay projections. x (B, S, D),
    x_prev (B, S, D) the sequence shifted right by one. Returns r, k, v
    (B, S, H, hd) in x's dtype and log_w (B, S, H, hd) fp32, the
    per-channel log decay, -exp(clip(w0 + lora(x), -8, 8))."""
    B, S, _ = x.shape
    H, hd = p["u"].shape

    def mix(mu):
        return x + mu * (x_prev - x)

    r = (mix(p["mu_r"]) @ p["w_r"]).reshape(B, S, H, hd)
    k = (mix(p["mu_k"]) @ p["w_k"]).reshape(B, S, H, hd)
    v = (mix(p["mu_v"]) @ p["w_v"]).reshape(B, S, H, hd)
    xw = mix(p["mu_w"]).float()
    dd = torch.tanh(xw @ p["w_lora_a"].float()) @ p["w_lora_b"].float()
    log_w = -torch.exp(torch.clamp(p["w0"].float() + dd, -8.0, 8.0))
    return r, k, v, log_w.reshape(B, S, H, hd)


def _pair_decays(Lq: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """exp(Lq_t - L_s) for s < t, 0 elsewhere: (..., C, hd) twice ->
    (..., t, s, hd)."""
    C = L.shape[-2]
    causal = torch.ones((C, C), dtype=torch.bool,
                        device=L.device).tril(-1)[:, :, None]
    diff = Lq[..., :, None, :] - L[..., None, :, :]
    return torch.exp(torch.where(causal, diff, NEG_INF))


class _RwkvScores(torch.autograd.Function):
    """One chunk's intra-chunk scores att[t, s] = sum_c r[t,c] k[s,c]
    exp(Lq[t,c] - L[s,c]) for s < t, else 0 ("bhtc,bhsc,bhtsc->bhts" as
    one product and sum over c). The backward recomputes the (..., C, C,
    hd) pairwise decays from the saved inputs, as the reference's
    ``jax.checkpoint`` of its chunk body does: autograd would keep two
    such tensors per chunk (0.5 GB each at 8 x 64 heads of 64).
    With E the decays, dr = sum_s g E k, dk = sum_t g E r, and since E's
    exponent is Lq_t - L_s, dLq = r dr and dL = -k dk."""
    generate_vmap_rule = True

    @staticmethod
    def forward(r, k, Lq, L):
        att = (r[..., :, None, :] * k[..., None, :, :]
               * _pair_decays(Lq, L)).sum(-1)
        C = L.shape[-2]
        causal = torch.ones((C, C), dtype=torch.bool,
                            device=L.device).tril(-1)
        return torch.where(causal, att, 0.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        r, k, Lq, L = ctx.saved_tensors
        # torch.func.grad differentiates with create_graph=True: recorded,
        # this backward would keep its (..., t, s, c) products for a
        # second derivative nobody takes
        with torch.no_grad():
            ge = g[..., None] * _pair_decays(Lq, L)          # (..., t, s, c)
            dr = (ge * k[..., None, :, :]).sum(-2)
            dk = (ge * r[..., :, None, :]).sum(-3)
            return dr, dk, r * dr, -(k * dk)


class _ChunkShards:
    """The RWKV chunk loop on each rank's own (batch, head) shard, for
    DTensor operands (a pod mesh): every product of the loop is
    independent per (row, head), so the chunking, the loop and the
    unchunking run on local tensors, as XLA runs the reference's scan
    body, and the outputs are wrapped back. (DTensor would flatten the
    sharded (batch, head) dims of each product into strided shards and
    plan every one of them anew; torch 2.11's pad rule fails on a 3-D
    mesh.)"""

    def __init__(self, r):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh = r.device_mesh
        # (B, S, H, hd) off the sequence: sharded on the batch or the heads
        self.seq = [p if p in (Shard(0), Shard(2)) else Replicate()
                    for p in _off_sequence(r)]
        # u (H, hd) and the state (B, H, hd, hd) on the same shards
        self.u = [Shard(0) if p == Shard(2) else Replicate()
                  for p in self.seq]
        self.state = [Shard(min(p.dim, 1)) if p.is_shard() else Replicate()
                      for p in self.seq]

    def local(self, *ts):
        """The (B, S, H, hd) tensors, u and the state as local tensors."""
        *seq, u, state = ts
        # u is replicated over the batch's mesh dims, each rank using it
        # on its own rows: its gradient is partial there
        rows = [i for i, p in enumerate(self.seq) if p.is_shard()
                and p.dim == 0]
        return ([local_shard(t, self.mesh, self.seq) for t in seq]
                + [local_shard(u, self.mesh, self.u, partial=rows),
                   local_shard(state, self.mesh, self.state)])

    def placed(self, o, state):
        """The outputs (B, S, H, hd) and the state, wrapped."""
        from torch.distributed.tensor import DTensor
        out = []
        for t, pl in ((o, self.seq), (state, self.state)):
            shape = list(t.shape)
            for i, p in enumerate(pl):
                if p.is_shard():
                    shape[p.dim] *= self.mesh.size(i)
            stride = [math.prod(shape[d + 1:]) for d in range(len(shape))]
            out.append(DTensor.from_local(t, self.mesh, pl, run_check=False,
                                          shape=torch.Size(shape),
                                          stride=tuple(stride)))
        return out


def rwkv_forward(x: torch.Tensor, p: dict, state: Optional[dict] = None,
                 chunk: int = 64):
    """RWKV-6 time mix over a full sequence, chunked linear-attention form.
    x (B, S, D); state {'S', 'x_prev'} carried in, or None. Returns (y
    (B, S, D), {'S': (B, H, hd, hd) fp32, 'x_prev': (B, D)}).

    Within a chunk, position t reads key s < t decayed by exp(Lq_t -
    L_s) <= 1 (L the inclusive cumulative log decay, Lq = L - log_w the
    exclusive one, as decode reads S_{t-1}), plus the bonus u on its own
    key; the state carried from the chunks before enters decayed by
    exp(Lq_t). A Python loop over chunks carries the state. A ragged
    last chunk is padded with zero log decay (w = 1, harmless). The
    intra-chunk scores (``_RwkvScores``) recompute their pairwise decays
    in the backward, so a gradient pass keeps O(S) per layer."""
    B, S, D = x.shape
    H, hd = p["u"].shape
    x_prev0 = x.new_zeros((B, 1, D)) if state is None \
        else state["x_prev"][:, None]
    x_shift = torch.cat([x_prev0, x[:, :-1]], dim=1)
    r, k, v, log_w = _rwkv_projections(x, p, x_shift)
    u = p["u"].float()
    S0 = x.new_zeros((B, H, hd, hd), dtype=torch.float32) \
        if state is None else state["S"].float()
    shards = None if _dtensor(r) is None else _ChunkShards(r)
    if shards is not None:
        r, k, v, log_w, u, S0 = shards.local(r, k, v, log_w, u, S0)
    Bl, Hl = r.shape[0], r.shape[2]
    nb = cdiv(S, chunk)
    pad = nb * chunk - S

    def to_chunks(t):  # (B, S, H, hd) -> (nb, B, H, chunk, hd) fp32
        t = F.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(Bl, nb, chunk, Hl, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, log_w))
    Lc = torch.cumsum(lwc, dim=3)
    outs = []
    for rb, kb, vb, Lb, lwb in zip(rc, kc, vc, Lc, lwc):     # (B, H, C, hd)
        Lq = Lb - lwb
        o_intra = _RwkvScores.apply(rb, kb, Lq, Lb) @ vb
        o_diag = (rb * (u[None, :, None, :] * kb)).sum(-1, keepdim=True) \
            * vb
        o_inter = (rb * torch.exp(Lq)) @ S0
        last = Lb[:, :, -1:, :]                               # (B, H, 1, hd)
        kdec = kb * torch.exp(last - Lb)
        S0 = torch.exp(last).transpose(2, 3) * S0 + kdec.transpose(2, 3) @ vb
        outs.append(o_intra + o_diag + o_inter)
    o = torch.stack(outs)
    o = o.permute(1, 0, 3, 2, 4).reshape(Bl, nb * chunk, Hl, hd)[:, :S]
    if shards is not None:
        o, S0 = shards.placed(o, S0)
    y = o.reshape(B, S, H * hd).to(x.dtype) @ p["w_o"]
    return y, {"S": S0, "x_prev": x[:, -1]}


def rwkv_decode(x: torch.Tensor, p: dict, state: dict):
    """One step. x (B, 1, D); state {'S': (B, H, hd, hd) fp32, 'x_prev':
    (B, D)}. Returns (y (B, 1, D), the new state)."""
    B = x.shape[0]
    H, hd = p["u"].shape
    r, k, v, log_w = _rwkv_projections(x, p, state["x_prev"][:, None])
    r, k, v = (t[:, 0].float() for t in (r, k, v))           # (B, H, hd)
    w = torch.exp(log_w[:, 0])
    u = p["u"].float()
    S = state["S"].float()
    kv = k[..., :, None] * v[..., None, :]                   # (B, H, hd, hd)
    o = _state_read(r, S + u[None, :, :, None] * kv)
    y = o.reshape(B, 1, H * hd).to(x.dtype) @ p["w_o"]
    return y, {"S": w[..., :, None] * S + kv, "x_prev": x[:, 0]}


def _state_read(r: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """r (B, H, hd) read through M (B, H, hd, hd): (r M) per (row, head).
    DTensors (a pod mesh's decode) run on each rank's own (batch, head)
    shard of M, r placed alike, and the result is wrapped back: DTensor
    would flatten the sharded batch and head dims into one for the
    batched product, which torch 2.11's view rule refuses."""
    if _dtensor(M) is None:
        return (r[..., None, :] @ M)[..., 0, :]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = M.device_mesh
    pl = [p if p in (Shard(0), Shard(1)) else Replicate()
          for p in M.placements]
    o = _state_read(local_shard(r, mesh, pl), local_shard(M, mesh, pl))
    return DTensor.from_local(o, mesh, pl, run_check=False)


def rwkv_init_state(batch: int, num_heads: int, head_dim: int, d: int,
                    dtype, *, lead: tuple = (), device=None) -> dict:
    """Zero state, with ``lead`` axes in front (stacked periods)."""
    return {"S": torch.zeros(lead + (batch, num_heads, head_dim, head_dim),
                             dtype=torch.float32, device=device),
            "x_prev": torch.zeros(lead + (batch, d), dtype=dtype,
                                  device=device)}
