"""Partition rules: map parameter / activation trees to partition specs
(counterpart of ``repro.sharding.rules``), and specs to
``torch.distributed.tensor`` placements.

Mesh axes (``launch.mesh``):
    one pod   : ("data", "model")
    multi-pod : ("pod", "data", "model")

Policy:
  * "model" — tensor parallel: heads / d_ff / vocab.
  * "data"  — the FEDERATED axis: batch sharding AND FSDP for params;
              the chain engine's chains and a served ensemble's draws.
  * "pod"   — pure data parallel across pods (params replicated over pod;
              a batch shards over (pod, data)).

A spec is a ``P``: one entry per tensor dim, a mesh axis name, a tuple of
names, or None (replicated). Rules are name-based over the parameter
dict's keys (``models.param_layout``); dims that the axis does not divide
fall back to replication (whisper's 20 heads on a 16-way model axis).
``mesh`` is a DeviceMesh or a mapping {axis name: size}.

The chain engine and the server place chains and draws along 'data'
(``chain_spec``, ``ensemble_spec``) and keep the shard stack, the bank
and a streamed window replicated (``stream_window_spec``); the other
specs (parameters, batches, caches) describe the tensor-parallel layout
a dry run reads.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

from repro_torch import tree as tu

PyTree = Any


class P(tuple):
    """A partition spec: ``P('data', None)`` shards dim 0 over 'data' and
    replicates dim 1; ``P()`` replicates every dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


# param-name -> (dim -> logical axis); logical axes: 'fsdp' | 'mdl' | None
_RULES = {
    # embeddings / head
    "embed": ("mdl", "fsdp"),
    "head": ("fsdp", "mdl"),
    # attention
    "wq": ("fsdp", "mdl"),
    "wk": ("fsdp", "mdl"),
    "wv": ("fsdp", "mdl"),
    "wo": ("mdl", "fsdp"),
    # dense ffn
    "wi_gate": ("fsdp", "mdl"),
    "wi_up": ("fsdp", "mdl"),
    # moe
    "router": ("fsdp", None),
    "experts_wi_gate": (None, "fsdp", "mdl"),
    "experts_wi_up": (None, "fsdp", "mdl"),
    "experts_wo": (None, "mdl", "fsdp"),
    # rglru
    "w_x": ("fsdp", "mdl"),
    "w_gate": ("fsdp", "mdl"),
    "w_out": ("mdl", "fsdp"),
    "w_rec": ("fsdp", "mdl"),
    "w_inp": ("fsdp", "mdl"),
    "conv_w": (None, "mdl"),
    "lam": ("mdl",),
    # rwkv
    "w_r": ("fsdp", "mdl"),
    "w_k": ("fsdp", "mdl"),
    "w_v": ("fsdp", "mdl"),
    "w_o": ("mdl", "fsdp"),
    "w_lora_a": ("fsdp", None),
    "w_lora_b": (None, None),
    "u": ("mdl", None),
}


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def logical_axes(mesh):
    """Logical axis names resolved to mesh axes for this mesh, and the
    axes a batch shards over."""
    axes = {"mdl": "model", "fsdp": "data"}
    batch = ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)
    return axes, batch


def _leaf_spec(name: str, shape, shape_of: dict, axes: dict) -> P:
    rule = _RULES.get(name)
    if rule is None:
        return P()  # norms, scalars, mix vectors, gates: replicate
    # stacked layer dims prepend leading axes: right-align the rule
    offset = len(shape) - len(rule)
    if offset < 0:  # e.g. a (1,)-shaped gate under a 2-D rule
        return P()
    spec = [None] * len(shape)
    for i, ax in enumerate(rule):
        if ax is None:
            continue
        mesh_axis = axes[ax]
        if mesh_axis is None or mesh_axis not in shape_of:
            continue  # axis disabled (the serving layout drops 'fsdp')
        if shape[offset + i] % shape_of[mesh_axis] == 0:
            spec[offset + i] = mesh_axis
        # else: replicated on that dim (uneven; e.g. whisper's heads)
    return P(*spec)


def _with_names(fn, tree: PyTree) -> PyTree:
    """``fn(path, leaf)`` over the tree, path the '/'-joined keys."""
    named, treedef = tu.flatten(tree)
    names = [n for n, _ in tu.leaves_with_names(tree)]
    return tu.unflatten(treedef, [fn(n, l) for n, l in zip(names, named)])


def param_specs(params: PyTree, mesh, *, serve: bool = False,
                serve_hbm_budget: float = 8 * 2**30) -> PyTree:
    """One spec per parameter leaf. ``serve=True`` is the SERVING layout:
    when the whole model (bf16) fits per device with model-axis-only
    sharding, the FSDP ('data') axis is dropped, so weights stay
    resident and only decode activations move; models too big for that
    keep the 2-D layout."""
    shape_of = mesh_shape(mesh)
    axes, _ = logical_axes(mesh)
    if serve:
        total_bf16 = sum(l.numel() * 2 for l in tu.leaves(params))
        if total_bf16 / shape_of["model"] <= serve_hbm_budget:
            axes = dict(axes, fsdp=None)
    return _with_names(lambda n, l: _leaf_spec(n.split("/")[-1], l.shape,
                                               shape_of, axes), params)


def placements(spec: P, mesh) -> list:
    """A spec as ``torch.distributed.tensor`` placements, one per mesh
    axis: Shard(dim) where a tensor dim is on that axis, else
    Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_shape(mesh):
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def local_shard(t, mesh, pl, partial=()):
    """This rank's shard of tensor ``t`` placed by ``pl`` on ``mesh``: a
    DTensor redistributed there, a plain tensor taken as replicated. Over
    the mesh dims ``partial`` (where ``pl`` replicates t but each rank
    uses it on its own shard of another tensor) the gradient is partial:
    the backward sums it over those dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    t = t.redistribute(mesh, pl)
    if not partial:
        return t.to_local()
    return t.to_local(grad_placements=[
        Partial() if i in partial else p for i, p in enumerate(pl)])


def param_shardings(params: PyTree, mesh) -> PyTree:
    """``param_specs`` as placements, one list per parameter leaf."""
    specs = [_leaf_spec(n.split("/")[-1], l.shape, mesh_shape(mesh),
                        logical_axes(mesh)[0])
             for n, l in tu.leaves_with_names(params)]
    return tu.unflatten(tu.flatten(params)[1],
                        [placements(s, mesh) for s in specs])


def _batch_axes(mesh):
    """(the spec entry of the batch axes: a name, or a tuple of names
    across pods; how many ranks they span)."""
    shape_of = mesh_shape(mesh)
    _, baxes = logical_axes(mesh)
    bsize = 1
    for a in baxes:
        bsize *= shape_of[a]
    return (baxes if len(baxes) > 1 else baxes[0]), bsize


def batch_specs(batch: PyTree, mesh) -> PyTree:
    """Shard the leading (global batch) dim over (pod?, data) when it
    divides; otherwise replicate (a batch of 1)."""
    baxes, bsize = _batch_axes(mesh)

    def spec(leaf):
        if leaf.ndim >= 1 and leaf.shape[0] % bsize == 0:
            return P(baxes)
        return P()
    return tu.tree_map(spec, batch)


def cache_specs(cache: PyTree, mesh) -> PyTree:
    """Decode caches / recurrent states: batch on dim 1 of stacked
    'blocks' caches (layers, B, ...), dim 0 of remainder caches; kv heads
    (or, for GQA with fewer kv heads than the model axis, the cache's
    sequence dim) and RWKV's state heads over 'model' where they
    divide."""
    baxes, bsize = _batch_axes(mesh)
    m = mesh_shape(mesh)["model"]

    def leaf_spec(path, leaf):
        keys = path.split("/")
        bdim = 1 if keys[0] == "blocks" else 0
        spec = [None] * leaf.ndim
        if leaf.ndim > bdim and leaf.shape[bdim] % bsize == 0:
            spec[bdim] = baxes
        name = keys[-1]
        if name in ("k", "v") and leaf.ndim == bdim + 4:
            kdim, sdim = bdim + 2, bdim + 1
            if leaf.shape[kdim] % m == 0:
                spec[kdim] = "model"
            elif leaf.shape[sdim] % m == 0:
                spec[sdim] = "model"
        if name == "S" and leaf.ndim == bdim + 4:  # rwkv state (B,H,hd,hd)
            if leaf.shape[bdim + 1] % m == 0:
                spec[bdim + 1] = "model"
        return P(*spec)

    return _with_names(leaf_spec, cache)


def surrogate_specs(params_specs: PyTree) -> PyTree:
    """Surrogate means shard exactly like the params they mirror; scalar
    precisions replicate."""
    return params_specs


# ---------------------------------------------------------------------------
# the chain-parallel (federated) layout of the chain engine
# ---------------------------------------------------------------------------

CHAIN_AXIS = "data"


def chain_spec() -> P:
    """A leading chain axis on 'data' (``core.engine.ChainBlock``: each
    data rank holds ceil(C / |data|) chains, the pad at the global
    tail)."""
    return P(CHAIN_AXIS)


def packed_chain_spec() -> P:
    """The chain-major (C * rows_total, 128) packed buffers: dim 0 on the
    chain axis, so every chain's whole segment stays on its rank. Each
    rank packs its own block (one launch of the update per step per
    rank); the SGHMC momentum buffer shares the spec."""
    return P(CHAIN_AXIS, None)


def stream_window_spec() -> P:
    """A streamed window's operands (resident ids, sizes, the (K, max_n,
    ...) rows) are REPLICATED: any chain can be reassigned to any
    resident client, so every data rank stages the same window; only the
    chains ride 'data'."""
    return P()


def fed_carry_spec() -> P:
    """The federated carry's per-chain rows (the compression reference
    and error feedback, (C, P)) shard over 'data' with the chains; the
    held client ids (C,) are replicated, since every rank draws the whole
    round. FA-LD's average is the one cross-chain reduction, a gather
    over 'data'."""
    return P(CHAIN_AXIS)


def chain_specs(tree: PyTree) -> PyTree:
    """Per-leaf chain-axis specs for a tree of (C, ...) chain states."""
    return tu.tree_map(lambda _: P(CHAIN_AXIS), tree)


def chain_shardings(tree: PyTree, mesh) -> PyTree:
    return tu.tree_map(lambda _: placements(P(CHAIN_AXIS), mesh), tree)


# ---------------------------------------------------------------------------
# the ensemble-serving layout: K draws on the same axis the chains sampled
# on; a K the axis does not divide is replicated (serve.EnsembleServer)
# ---------------------------------------------------------------------------

ENSEMBLE_AXIS = CHAIN_AXIS


def ensemble_spec() -> P:
    """A leading draw axis on 'data'."""
    return P(ENSEMBLE_AXIS)


def ensemble_specs(tree: PyTree) -> PyTree:
    """Per-leaf draw-axis specs for (K, ...) stacked draws / caches."""
    return tu.tree_map(lambda _: P(ENSEMBLE_AXIS), tree)


def ensemble_shardings(tree: PyTree, mesh) -> PyTree:
    """Placements for a stacked-draw tree; requires K % |data| == 0
    (callers replicate otherwise)."""
    return tu.tree_map(lambda _: placements(P(ENSEMBLE_AXIS), mesh), tree)
