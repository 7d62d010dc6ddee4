"""Public wrappers around the fused FSGLD update kernel (counterpart of
``repro.kernels.ops``).

``fused_update_{flat,chains_flat,chains_tree,tree}`` apply the per-leaf
entry ``fsgld_update_2d``: ravel, pad to (rows, 128), update, unpad. They
pad each leaf to the packed layout's 8-row block, not the TPU's 256-row
tile: on the card the block only sizes the segment table, and the noise
index is the element's index within its leaf, so any block gives the same
result and the smallest moves the fewest pad bytes. The
per-(chain, leaf) seeds arrive as integer tensors drawn by the caller from
a ``torch.Generator`` (the JAX package derives them from PRNG keys).

``PackedChains`` is the single-launch layout: every leaf of every chain
lives in ONE chain-major (C * rows_total, 128) float32 buffer, and
``packed_step`` updates the whole chain block with one launch of
``fsgld_update_packed`` over the layout's segment table. Non-fp32 leaves
ride the fp32 buffer with a per-step ``quantize`` round trip back to their
storage dtype, as the per-leaf path casts each leaf back every step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tree as tu
from repro_torch.kernels.fsgld_update import (LANE, PACK_BLOCK_ROWS,
                                              SCALAR_COLS, fsgld_update_2d,
                                              fsgld_update_packed)

PyTree = Any


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _pad_2d(vec: torch.Tensor, block_rows: int):
    """Flat vector -> zero-padded (rows, 128) float32, rows a multiple of
    block_rows; returns (buffer, live length)."""
    n = vec.shape[0]
    per_block = block_rows * LANE
    padded = -(-n // per_block) * per_block
    buf = torch.zeros(padded, dtype=torch.float32, device=vec.device)
    buf[:n] = vec
    return buf.reshape(-1, LANE), n


def _scalars_row(device, h, scale, f_s, prior_prec, alpha, temperature,
                 lam_g, lam_s, friction=0.0) -> torch.Tensor:
    vals = [h, scale, f_s, prior_prec, alpha, temperature, lam_g, lam_s,
            friction]
    return torch.stack([_f32(v, device).reshape(()) for v in vals]
                       ).reshape(1, SCALAR_COLS)


def _variant_of(mu_g, lam_g) -> str:
    if mu_g is None:
        return "plain"
    return "scalar" if torch.as_tensor(lam_g).ndim == 0 else "diag"


def fused_update_flat(theta: torch.Tensor, g: torch.Tensor, seed, *, h,
                      scale, f_s=1.0, prior_prec=0.0, alpha=0.0,
                      temperature=1.0, mu_g=None, mu_s=None, lam_g=None,
                      lam_s=None, momentum=None, friction=0.0,
                      dynamics: str = "langevin",
                      block_rows: int = PACK_BLOCK_ROWS):
    """Fused update of one tensor (any shape). ``seed``: integer scalar.
    Returns theta' ('langevin') or (theta', momentum') ('sghmc'), cast
    back to the inputs' dtypes."""
    dev = theta.device
    orig_shape, orig_dtype = theta.shape, theta.dtype
    th2, n = _pad_2d(theta.reshape(-1), block_rows)
    g2, _ = _pad_2d(g.reshape(-1), block_rows)
    rows = th2.shape[0]
    br = min(block_rows, rows)
    while rows % br:
        br //= 2
    variant = _variant_of(mu_g, lam_g)
    kw = {}
    lam_row = (0.0, 0.0)
    if variant != "plain":
        kw["mu_g"] = _pad_2d(mu_g.reshape(-1), block_rows)[0]
        kw["mu_s"] = _pad_2d(mu_s.reshape(-1), block_rows)[0]
    if variant == "scalar":
        lam_row = (lam_g, lam_s)
    elif variant == "diag":
        kw["lam_g"] = _pad_2d(lam_g.reshape(-1), block_rows)[0]
        kw["lam_s"] = _pad_2d(lam_s.reshape(-1), block_rows)[0]
    if dynamics == "sghmc":
        kw["r2d"] = _pad_2d(momentum.reshape(-1), block_rows)[0]
    sc = _scalars_row(dev, h, scale, f_s, prior_prec, alpha, temperature,
                      *lam_row, friction)
    seed_t = torch.as_tensor(seed, device=dev).reshape(1).to(torch.int64)
    out = fsgld_update_2d(th2, g2, seed_t, sc, variant=variant,
                          dynamics=dynamics, block_rows=br, **kw)

    def unpad(o, dt):
        return o.reshape(-1)[:n].reshape(orig_shape).to(dt)

    if dynamics == "sghmc":
        return unpad(out[0], orig_dtype), unpad(out[1], momentum.dtype)
    return unpad(out, orig_dtype)


def fused_update_chains_flat(theta: torch.Tensor, g: torch.Tensor,
                             seeds: torch.Tensor, *, h, scale, f_s,
                             prior_prec=0.0, alpha=0.0, temperature=1.0,
                             mu_g=None, mu_s=None, lam_g=None, lam_s=None,
                             momentum=None, friction=0.0,
                             dynamics: str = "langevin",
                             block_rows: int = PACK_BLOCK_ROWS):
    """CHAIN-BATCHED update of one leaf: one launch for the chain block.

    theta, g: (C, ...); seeds: (C,) integer; scale, f_s: (C,) or scalars.
    mu_g / lam_g: the shared global surrogate ((P,) or a scalar lam);
    mu_s / lam_s: per-chain ((C, P), or (C,) scalar lams)."""
    dev = theta.device
    C = theta.shape[0]
    orig_shape, orig_dtype = theta.shape, theta.dtype
    per_block = block_rows * LANE
    n = theta.reshape(C, -1).shape[1]
    padded = -(-n // per_block) * per_block

    def pad_chains(x):  # (C, ...) -> (C * rows_c, LANE)
        buf = torch.zeros(C, padded, dtype=torch.float32, device=dev)
        buf[:, :n] = x.reshape(C, -1)
        return buf.reshape(-1, LANE)

    def pad_shared(x):  # (P,) -> (rows_c, LANE), on theta's device
        return _pad_2d(x.reshape(-1).to(dev), block_rows)[0]

    def col(v):
        return torch.broadcast_to(_f32(v, dev), (C,))

    th2, g2 = pad_chains(theta), pad_chains(g)
    rows_c = th2.shape[0] // C
    variant = _variant_of(mu_g, lam_g)
    kw = {}
    lam_rows = (col(0.0), col(0.0))
    if variant != "plain":
        kw["mu_g"] = pad_shared(mu_g)
        kw["mu_s"] = pad_chains(mu_s)
    if variant == "scalar":
        lam_rows = (col(lam_g), col(lam_s))
    elif variant == "diag":
        kw["lam_g"] = pad_shared(lam_g)
        kw["lam_s"] = pad_chains(lam_s)
    if dynamics == "sghmc":
        kw["r2d"] = pad_chains(momentum)
    sc = torch.stack([col(h), col(scale), col(f_s), col(prior_prec),
                      col(alpha), col(temperature), lam_rows[0], lam_rows[1],
                      col(friction)], dim=1)
    out = fsgld_update_2d(th2, g2, seeds.reshape(C), sc, variant=variant,
                          dynamics=dynamics, block_rows=min(block_rows, rows_c),
                          chains=C, **kw)

    def unpad(o, dt):
        return o.reshape(C, -1)[:, :n].reshape(orig_shape).to(dt)

    if dynamics == "sghmc":
        return unpad(out[0], orig_dtype), unpad(out[1], momentum.dtype)
    return unpad(out, orig_dtype)


def _bank_operands(bank, sids, surrogate_kind, num_leaves):
    """Per-leaf (mu_g, mu_s, lam_g, lam_s) lists for the chain-batched
    path; mu_s/lam_s gathered at the chains' resident clients ``sids``
    where the means lie (the host, say)."""
    L = num_leaves
    if bank is None:
        return [None] * L, [None] * L, [None] * L, [None] * L
    if surrogate_kind == "diag":
        if L != 1:
            raise ValueError("diag surrogates operate on flat vectors")
        return ([bank.global_.mean], [bank.means[sids]],
                [bank.global_.prec], [bank.precs[sids]])
    if surrogate_kind == "scalar":
        return (tu.leaves(bank.global_.mean),
                [m[sids.to(m.device)] for m in tu.leaves(bank.means)],
                tu.leaves(bank.global_.prec),
                [p[sids] for p in tu.leaves(bank.precs)])
    raise ValueError(surrogate_kind)


def fused_update_chains_tree(theta: PyTree, g: PyTree, seeds: torch.Tensor,
                             *, h, scale, f_s, prior_prec=0.0, alpha=0.0,
                             temperature=1.0, bank=None, sids=None,
                             surrogate_kind: Optional[str] = None,
                             momentum: Optional[PyTree] = None,
                             friction=0.0, dynamics: str = "langevin"):
    """Chain-batched update of a pytree whose leaves carry a leading chain
    axis: one launch per leaf. seeds: (C, L) integer, column l seeding
    leaf l (the same seeds the packed path takes, so both paths draw the
    same noise). bank: SurrogateBank ('diag' or 'scalar') with ``sids``
    (C,) selecting each chain's client, or None for SGLD/DSGLD."""
    leaves, treedef = tu.flatten(theta)
    gleaves = tu.leaves(g)
    rleaves = (tu.leaves(momentum) if momentum is not None
               else [None] * len(leaves))
    mu_gs, mu_ss, lgs, lss = _bank_operands(bank, sids, surrogate_kind,
                                            len(leaves))
    out, out_r = [], []
    for i, (t, gg, rr) in enumerate(zip(leaves, gleaves, rleaves)):
        res = fused_update_chains_flat(
            t, gg, seeds[:, i], h=h, scale=scale, f_s=f_s,
            prior_prec=prior_prec, alpha=alpha, temperature=temperature,
            mu_g=mu_gs[i], mu_s=mu_ss[i], lam_g=lgs[i], lam_s=lss[i],
            momentum=rr, friction=friction, dynamics=dynamics)
        if dynamics == "sghmc":
            out.append(res[0])
            out_r.append(res[1])
        else:
            out.append(res)
    if dynamics == "sghmc":
        return tu.unflatten(treedef, out), tu.unflatten(treedef, out_r)
    return tu.unflatten(treedef, out)


def fused_update_tree(theta: PyTree, g: PyTree, seeds: torch.Tensor, *, h,
                      scale, f_s=1.0, prior_prec=0.0, alpha=0.0,
                      temperature=1.0, q_global=None, q_shard=None,
                      surrogate_kind: Optional[str] = None,
                      momentum: Optional[PyTree] = None, friction=0.0,
                      dynamics: str = "langevin"):
    """Single-chain fused update across a parameter pytree. seeds: (L,)
    integer, one per leaf. q_global/q_shard: ``Gaussian`` surrogates with
    'diag' (flat vector) or 'scalar' (pytree means + per-leaf scalar
    precisions) structure, or None for SGLD/DSGLD."""
    leaves, treedef = tu.flatten(theta)
    gleaves = tu.leaves(g)
    rleaves = (tu.leaves(momentum) if momentum is not None
               else [None] * len(leaves))
    L = len(leaves)
    if q_global is None:
        mu_gs = mu_ss = lgs = lss = [None] * L
    elif surrogate_kind == "diag":
        if L != 1:
            raise ValueError("diag surrogates operate on flat vectors")
        mu_gs, mu_ss = [q_global.mean], [q_shard.mean]
        lgs, lss = [q_global.prec], [q_shard.prec]
    elif surrogate_kind == "scalar":
        mu_gs, mu_ss = tu.leaves(q_global.mean), tu.leaves(q_shard.mean)
        lgs, lss = tu.leaves(q_global.prec), tu.leaves(q_shard.prec)
    else:
        raise ValueError(surrogate_kind)
    out, out_r = [], []
    for i, (t, gg, rr) in enumerate(zip(leaves, gleaves, rleaves)):
        res = fused_update_flat(
            t, gg, seeds[i], h=h, scale=scale, f_s=f_s,
            prior_prec=prior_prec, alpha=alpha, temperature=temperature,
            mu_g=mu_gs[i], mu_s=mu_ss[i], lam_g=lgs[i], lam_s=lss[i],
            momentum=rr, friction=friction, dynamics=dynamics)
        if dynamics == "sghmc":
            out.append(res[0])
            out_r.append(res[1])
        else:
            out.append(res)
    if dynamics == "sghmc":
        return tu.unflatten(treedef, out), tu.unflatten(treedef, out_r)
    return tu.unflatten(treedef, out)


# ---------------------------------------------------------------------------
# packed single-launch chain-state layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedChains:
    """STATIC layout of a parameter pytree packed into one chain-major
    (C * rows_total, 128) float32 buffer.

    Leaf l owns rows [row_offsets[l], row_offsets[l] + rows[l]) of every
    chain's segment; its first ``sizes[l]`` elements are live, the tail is
    pad (written by the kernel, never read back). Block j of a chain
    belongs to leaf ``seg_leaf[j]`` and starts at in-leaf element
    ``seg_base[j]``: that base keeps the noise stream the per-leaf path's.
    """
    treedef: Any
    shapes: tuple
    dtypes: tuple
    sizes: tuple          # live element count per leaf
    rows: tuple           # padded row count per leaf (block_rows multiple)
    row_offsets: tuple    # first row of each leaf inside a chain segment
    rows_total: int
    block_rows: int
    seg_leaf: tuple       # in-chain block -> leaf id
    seg_base: tuple       # in-chain block -> element offset within leaf
    _tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                      hash=False, repr=False)

    @property
    def num_leaves(self) -> int:
        return len(self.shapes)

    @property
    def bpc(self) -> int:
        """Blocks per chain."""
        return len(self.seg_leaf)

    def tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(seg_leaf, seg_base) as int32 tensors on ``device``, uploaded
        once per layout and device, not per step."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = tuple(
                torch.tensor(t, dtype=torch.int32, device=device)
                for t in (self.seg_leaf, self.seg_base))
        return self._tables[device]

    def pack(self, tree: PyTree, out: Optional[torch.Tensor] = None, *,
             dtype=torch.float32, device=None) -> torch.Tensor:
        """Leaves (C, *shape) -> (C * rows_total, 128) ``dtype`` (float32
        by default), chain-major, on ``device`` (default: the leaves'; the
        leaves may lie elsewhere, e.g. on the host, and are copied leaf by
        leaf). With ``out`` the live elements are copied into that buffer
        IN PLACE (its pad keeps whatever it held) and it is returned; else
        a new zero-padded buffer is built."""
        leaves, treedef = tu.flatten(tree)
        if treedef != self.treedef:
            raise ValueError(f"tree {treedef} does not match the layout's "
                             f"{self.treedef}")
        c = leaves[0].shape[0]
        if out is None:
            out = torch.zeros(c * self.rows_total, LANE, dtype=dtype,
                              device=device if device is not None
                              else leaves[0].device)
        flat = out.view(c, self.rows_total * LANE)
        for leaf, off, n in zip(leaves, self.row_offsets, self.sizes):
            flat[:, off * LANE:off * LANE + n].copy_(leaf.reshape(c, n))
        return out

    def pack_shared(self, tree: PyTree, device=None) -> torch.Tensor:
        """Chain-free pytree (global surrogate) -> (rows_total, 128)
        float32 on ``device`` (default: the leaves')."""
        return self.pack(tu.tree_map(lambda t: t[None], tree),
                         device=device)

    def views(self, buf: torch.Tensor) -> PyTree:
        """(C * rows_total, 128) -> leaves (C, *shape), every one a view
        into ``buf`` in its dtype (writes through them land in it)."""
        flat = buf.view(-1, self.rows_total * LANE)
        return tu.unflatten(self.treedef, [
            flat[:, off * LANE:off * LANE + n].reshape(
                (flat.shape[0],) + shape)
            for shape, off, n in zip(self.shapes, self.row_offsets,
                                     self.sizes)])

    def base_of(self, tree: PyTree) -> Optional[torch.Tensor]:
        """The packed buffer whose ``views`` ``tree``'s leaves are, or None
        (then packing it copies)."""
        leaves, treedef = tu.flatten(tree)
        base = getattr(leaves[0], "_base", None)
        if treedef != self.treedef or base is None or base.ndim != 2 \
                or base.shape[1] != LANE \
                or base.shape[0] % self.rows_total:
            return None
        for t, w in zip(leaves, tu.leaves(self.views(base))):
            if not (t._base is base and t.data_ptr() == w.data_ptr()
                    and t.shape == w.shape and t.stride() == w.stride()):
                return None
        return base

    def unpack(self, buf: torch.Tensor) -> PyTree:
        """(C * rows_total, 128) -> leaves (C, *shape) in their dtypes.
        fp32 leaves are views into ``buf``."""
        flat = buf.view(-1, self.rows_total * LANE)
        c = flat.shape[0]
        leaves = [flat[:, off * LANE:off * LANE + n]
                  .reshape((c,) + shape).to(dt)
                  for shape, dt, off, n in zip(self.shapes, self.dtypes,
                                               self.row_offsets, self.sizes)]
        return tu.unflatten(self.treedef, leaves)

    @property
    def all_fp32(self) -> bool:
        return all(dt == torch.float32 for dt in self.dtypes)

    def quantize(self, buf: torch.Tensor) -> torch.Tensor:
        """Storage-dtype round trip (fp32 -> leaf dtype -> fp32) of every
        non-fp32 leaf's rows, IN PLACE on ``buf``, which is returned. The
        same object, untouched, when every leaf is fp32."""
        if self.all_fp32:
            return buf
        flat = buf.view(-1, self.rows_total * LANE)
        for dt, off, r in zip(self.dtypes, self.row_offsets, self.rows):
            if dt != torch.float32:
                seg = flat[:, off * LANE:(off + r) * LANE]
                seg.copy_(seg.to(dt))
        return buf


def make_packed_layout(theta: PyTree,
                       block_rows: int = PACK_BLOCK_ROWS) -> PackedChains:
    """The packed layout of a SINGLE-chain example pytree (shapes without
    the leading chain axis)."""
    leaves, treedef = tu.flatten(theta)
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    sizes = tuple(int(l.numel()) for l in leaves)
    per_block = block_rows * LANE
    rows = tuple(-(-n // per_block) * block_rows for n in sizes)
    row_offsets, acc = [], 0
    for r in rows:
        row_offsets.append(acc)
        acc += r
    seg_leaf, seg_base = [], []
    for li, r in enumerate(rows):
        for b in range(r // block_rows):
            seg_leaf.append(li)
            seg_base.append(b * per_block)
    return PackedChains(
        treedef=treedef, shapes=shapes, dtypes=dtypes, sizes=sizes,
        rows=rows, row_offsets=tuple(row_offsets), rows_total=acc,
        block_rows=block_rows, seg_leaf=tuple(seg_leaf),
        seg_base=tuple(seg_base))


def chain_leaf_seeds(generator: torch.Generator, *shape: int
                     ) -> torch.Tensor:
    """Integer seeds in [0, 2^31 - 1) of the given shape (typically
    (T, C, L): one per step, chain and leaf), drawn from ``generator`` on
    its device, as int32."""
    return torch.randint(0, 2**31 - 1, shape, generator=generator,
                         device=generator.device, dtype=torch.int64
                         ).to(torch.int32)


def packed_scalar_rows(layout: PackedChains, *, h, scale, f_s, prior_prec,
                       alpha, temperature, lam_g_leaf=None, lam_s_leaf=None,
                       friction=0.0) -> torch.Tensor:
    """The (C, L, SCALAR_COLS) scalar rows for a round: scale and f_s vary
    per chain (its resident client), lam_g/lam_s per leaf in the 'scalar'
    variant ((L,) global / (C, L) resident); the rest broadcasts."""
    C = scale.shape[0]
    L = layout.num_leaves
    dev = scale.device

    def col(v):
        return torch.broadcast_to(_f32(v, dev), (C, L))

    lamg = col(0.0) if lam_g_leaf is None else col(lam_g_leaf[None])
    lams = col(0.0) if lam_s_leaf is None else col(lam_s_leaf)
    return torch.stack([
        col(h), col(scale[:, None]), col(f_s[:, None]), col(prior_prec),
        col(alpha), col(temperature), lamg, lams, col(friction)], dim=-1)


def packed_step(layout: PackedChains, theta_p: torch.Tensor,
                g_p: torch.Tensor, seeds: torch.Tensor,
                scalars: torch.Tensor, *, variant: str, mu_g=None, mu_s=None,
                lam_g=None, lam_s=None, r_p=None,
                dynamics: str = "langevin"):
    """ONE launch updating every leaf of every chain in the block, in
    place: theta_p (and r_p) are updated and returned. seeds: (C, L)
    integer; scalars: (C, L, SCALAR_COLS) from ``packed_scalar_rows``."""
    seg_leaf, seg_base = layout.tables(theta_p.device)
    return fsgld_update_packed(
        theta_p, g_p, seeds, scalars, variant=variant, dynamics=dynamics,
        r2d=r_p, mu_g=mu_g, mu_s=mu_s, lam_g=lam_g, lam_s=lam_s,
        seg_leaf=seg_leaf, seg_base=seg_base, block_rows=layout.block_rows,
        chains=seeds.shape[0])
