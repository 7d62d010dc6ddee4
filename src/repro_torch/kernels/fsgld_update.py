"""Fused FSGLD parameter update: the CUDA kernel's two entries, each with
its plain PyTorch version.

Counterpart of ``repro.kernels.fsgld_update`` (the Pallas TPU kernels
``fsgld_update_packed`` and ``fsgld_update_2d``). One elementwise pass
computes the FSGLD drift

    drift = -prior*theta + scale*g
            + alpha*[lam_g*(mu_g - theta) - (lam_s/f_s)*(mu_s - theta)]

and applies Langevin (theta' = theta + h/2*drift + sqrt(h*tau)*xi) or
naive-Euler SGHMC (r' = (1-a)r + h*drift + sqrt(2*a*tau)*sqrt(h)*xi,
theta' = theta + r'), with xi generated in the kernel from a counter hash
of (seed[chain, leaf], element index within the leaf). Drift variants:
'plain' (theta, g), 'scalar' (+ mu_g, mu_s, lambdas from the scalar row),
'diag' (+ mu_g, mu_s, lam_g, lam_s).

Operands are chain-major ``(C * rows_per_chain, 128)`` float32 buffers;
the shared operands mu_g / lam_g are ``(rows_per_chain, 128)``: the
kernel loads a tile of them once and walks the chains with it. The packed
entry updates theta (and r) in
place, which saves a buffer of the parameters' size; the per-leaf entry
returns new buffers. Dispatch is by device: a CPU tensor takes the plain version, a CUDA tensor launches the kernel (``csrc/fsgld_update.cu``,
built at first use by ``_build``) and any other device raises. The plain
version is the oracle the kernel is held against on the card, not a
fallback.

Both entries are ``torch.library`` custom ops on CUDA tensors,
``repro_torch::fsgld_update_2d`` (new buffers) and
``repro_torch::fsgld_update_packed`` (in place), with shape functions for
fake tensors (a dry run's, on any device: the wrappers pass a fake
tensor to the op) and a FLOP formula of 0 (the update's cost is its
bytes). The noise index of an element is its index within its leaf,
from the segment table: ``fsgld_update_2d(seg_base=)`` takes the table
of a leaf's shard, so a shard draws the noise the whole leaf draws
there. Sharded updates go through ``launch.steps.update_shard``, which
calls this entry on each rank's local shard with that table.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref

LANE = 128
BLOCK_ROWS = 256  # per-leaf entry: rows per block
PACK_BLOCK_ROWS = 8  # packed entry: rows per segment-table block

# scalar-operand layout: one float32 row per (chain, leaf)
(S_H, S_SCALE, S_FS, S_PRIOR, S_ALPHA, S_TEMP, S_LAMG, S_LAMS,
 S_FRIC) = range(9)
SCALAR_COLS = 9

VARIANTS = ("plain", "scalar", "diag")
DYNAMICS = ("langevin", "sghmc")

# Kernel launches per entry, and of either entry per dynamics: each
# wrapper adds one where it launches the CUDA kernel, and nowhere else
# (the plain version does not count).
LAUNCHES = {"fsgld_update_packed": 0, "fsgld_update_2d": 0}
DYNAMICS_LAUNCHES = {"langevin": 0, "sghmc": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, DYNAMICS_LAUNCHES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _update_plain(variant, dynamics, sc, th, g, r, sur, seed, idx):
    """Elementwise body. ``sc``: (rows, SCALAR_COLS) float32 per-row
    scalars; ``seed``: (rows, 1) and ``idx``: (rows, 128) noise
    coordinates. Expression order follows the Pallas kernel's."""
    col = lambda k: sc[:, k:k + 1]  # noqa: E731
    th = th.to(torch.float32)
    g = g.to(torch.float32)
    drift = -col(S_PRIOR) * th + col(S_SCALE) * g
    if variant == "scalar":
        mg, ms = sur
        cond = col(S_LAMG) * (mg - th) - (col(S_LAMS) / col(S_FS)) * (ms - th)
        drift = drift + col(S_ALPHA) * cond
    elif variant == "diag":
        mg, ms, lg, ls = sur
        cond = lg * (mg - th) - (ls / col(S_FS)) * (ms - th)
        drift = drift + col(S_ALPHA) * cond
    xi = ref.gaussian_noise(seed, idx)
    h = col(S_H)
    if dynamics == "langevin":
        sig = torch.sqrt(h * col(S_TEMP))
        return th + (h * 0.5) * drift + sig * xi
    a = col(S_FRIC)
    noise_sig = torch.sqrt(2.0 * a * col(S_TEMP))
    r_new = (1.0 - a) * r.to(torch.float32) + h * drift \
        + (noise_sig * torch.sqrt(h)) * xi
    return th + r_new, r_new


def _sur_plain(variant, chains, mu_g, mu_s, lam_g, lam_s):
    """Surrogate operands at full height: shared ones tiled per chain."""
    f = lambda t: t.to(torch.float32)  # noqa: E731
    if variant == "plain":
        return []
    if variant == "scalar":
        return [f(mu_g).repeat(chains, 1), f(mu_s)]
    return [f(mu_g).repeat(chains, 1), f(mu_s), f(lam_g).repeat(chains, 1),
            f(lam_s)]


PLAIN_CHUNK_ROWS = 1 << 16  # rows per pass of the packed entry's plain version


def fsgld_update_packed_plain(theta2d, g2d, seeds, scalars, *, variant,
                              dynamics, seg_leaf, seg_base, block_rows,
                              chains, r2d=None, mu_g=None, mu_s=None,
                              lam_g=None, lam_s=None,
                              chunk_rows: int = PLAIN_CHUNK_ROWS):
    """Plain version of the packed entry (same contract), computed over
    chunks of ``chunk_rows`` rows so that its int64 hash and float64
    noise temporaries stay bounded at billion-parameter shapes (the
    update is elementwise: chunking changes no value)."""
    rows = theta2d.shape[0]
    rows_total = rows // chains
    dev = theta2d.device
    seg_leaf = torch.as_tensor(seg_leaf, device=dev).to(torch.int64)
    seg_base = torch.as_tensor(seg_base, device=dev).to(torch.int64)
    seeds, scalars = seeds.to(torch.int64), scalars.to(torch.float32)
    hmc = dynamics == "sghmc"
    outs = [torch.empty(rows, LANE, dtype=torch.float32, device=dev)
            for _ in range(2 if hmc else 1)]
    f = lambda t: t.to(torch.float32)  # noqa: E731
    for r0 in range(0, rows, chunk_rows):
        rs = slice(r0, min(r0 + chunk_rows, rows))
        row = torch.arange(rs.start, rs.stop, device=dev)
        c, rr = row // rows_total, row % rows_total
        j = rr // block_rows
        leaf = seg_leaf[j]
        idx = (seg_base[j] + (rr % block_rows) * LANE)[:, None] \
            + torch.arange(LANE, device=dev)[None]
        # shared operands by in-chain row, per-chain ones by row
        sur = [] if variant == "plain" else [f(mu_g[rr]), f(mu_s[rs])]
        if variant == "diag":
            sur += [f(lam_g[rr]), f(lam_s[rs])]
        res = _update_plain(variant, dynamics, scalars[c, leaf],
                            theta2d[rs], g2d[rs],
                            r2d[rs] if hmc else None, sur,
                            seeds[c, leaf][:, None], idx)
        for o, x in zip(outs, res if hmc else (res,)):
            o[rs] = x
    return tuple(outs) if hmc else outs[0]


def fsgld_update_2d_plain(theta2d, g2d, seed, scalars, *, variant, dynamics,
                          chains, r2d=None, mu_g=None, mu_s=None, lam_g=None,
                          lam_s=None, seg_base=None, block_rows=BLOCK_ROWS):
    """Plain version of the per-leaf entry (same contract; the noise index
    is the element's index within its chain, whatever the block, or with
    ``seg_base`` its block's base plus its place in the block)."""
    rows = theta2d.shape[0]
    rows_c = rows // chains
    dev = theta2d.device
    row = torch.arange(rows, device=dev)
    c = row // rows_c
    if seg_base is None:
        first = (row % rows_c) * LANE
    else:
        br = min(block_rows, rows_c)
        rr = row % rows_c
        first = (torch.as_tensor(seg_base, device=dev).to(torch.int64)
                 & ref.MASK32)[rr // br] + (rr % br) * LANE
    idx = first[:, None] + torch.arange(LANE, device=dev)[None]
    s = seed.to(torch.int64).reshape(chains)[c][:, None]
    sc = scalars.to(torch.float32).reshape(chains, SCALAR_COLS)[c]
    sur = _sur_plain(variant, chains, mu_g, mu_s, lam_g, lam_s)
    return _update_plain(variant, dynamics, sc, theta2d, g2d, r2d, sur, s,
                         idx)


# ---------------------------------------------------------------------------
# argument checks and the CUDA launch
# ---------------------------------------------------------------------------

def _need(name, t, shape, dtype, device):
    if t is None:
        raise ValueError(f"{name} is required for this variant/dynamics")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")


def _check(variant, dynamics, theta2d, g2d, r2d, mu_g, mu_s, lam_g, lam_s,
           rows_c):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")
    if dynamics not in DYNAMICS:
        raise ValueError(f"unknown dynamics {dynamics!r}; pick from "
                         f"{DYNAMICS}")
    if theta2d.ndim != 2 or theta2d.shape[1] != LANE:
        raise ValueError(f"theta2d must be (rows, {LANE}), got "
                         f"{tuple(theta2d.shape)}")
    dev, full, shared = theta2d.device, theta2d.shape, (rows_c, LANE)
    f32 = torch.float32
    _need("theta2d", theta2d, full, f32, dev)
    _need("g2d", g2d, full, f32, dev)
    if dynamics == "sghmc":
        _need("r2d", r2d, full, f32, dev)
    if variant != "plain":
        _need("mu_g", mu_g, shared, f32, dev)
        _need("mu_s", mu_s, full, f32, dev)
    if variant == "diag":
        _need("lam_g", lam_g, shared, f32, dev)
        _need("lam_s", lam_s, full, f32, dev)


def _ptr(t, align: int = 16):
    """The operand's address; the (rows, 128) streams must be 16-byte
    aligned (the kernel moves float4 vectors), the tables and per-(chain,
    leaf) rows, read one value at a time, ``align=4`` (a step's seeds are
    a row of the round's (T, C, L) draw)."""
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"kernel operands must be {align}-byte aligned")
    return ctypes.c_void_p(t.data_ptr())


def _seeds_i32(seeds):
    if seeds.dtype.is_floating_point or seeds.dtype == torch.bool:
        raise ValueError(f"seeds must be integers, got {seeds.dtype}")
    if seeds.dtype == torch.int32:  # already the kernel's storage
        return seeds.contiguous()
    # uint32 bit pattern carried in int32 storage
    return (seeds.to(torch.int64) & ref.MASK32).to(torch.int32).contiguous()


def _launch(entry, variant, dynamics, theta2d, g2d, r2d, sur, seg_leaf,
            seg_base, seeds, scalars, rows_total, block_rows, num_leaves):
    """The packed entry updates in place; the per-leaf one writes new
    buffers."""
    from repro_torch.kernels import _build
    lib = _build.load("fsgld_update")
    dev = theta2d.device
    hmc = dynamics == "sghmc"
    inplace = entry == "fsgld_update_packed"
    out = theta2d if inplace else torch.empty_like(theta2d)
    r_out = (r2d if inplace else torch.empty_like(r2d)) if hmc else None
    mu_g, mu_s, lam_g, lam_s = (list(sur) + [None] * 4)[:4]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fsgld_update_launch(
            VARIANTS.index(variant), int(hmc),
            _ptr(theta2d), _ptr(r2d), _ptr(g2d), _ptr(mu_g), _ptr(mu_s),
            _ptr(lam_g), _ptr(lam_s), _ptr(seg_leaf, 4), _ptr(seg_base, 4),
            _ptr(seeds, 4), _ptr(scalars, 4), _ptr(out), _ptr(r_out),
            theta2d.shape[0], rows_total, block_rows, num_leaves,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{entry} launch failed: cudaError {err} "
            f"({lib.fsgld_update_error_string(err).decode()})")
    LAUNCHES[entry] += 1
    DYNAMICS_LAUNCHES[dynamics] += 1
    return (out, r_out) if hmc else out


_ONE_LEAF_TABLES: dict = {}


def _one_leaf_tables(device, bpc, br):
    """The per-leaf entry's segment table (seg_leaf = 0, seg_base[j] =
    j * br * 128) as int32 tensors on ``device``, uploaded once per
    (device, blocks, block rows), not per launch."""
    key = (device, bpc, br)
    if key not in _ONE_LEAF_TABLES:
        _ONE_LEAF_TABLES[key] = (
            torch.zeros(bpc, dtype=torch.int32, device=device),
            torch.arange(bpc, dtype=torch.int32, device=device) * (br * LANE))
    return _ONE_LEAF_TABLES[key]


def _sur_list(variant, mu_g, mu_s, lam_g, lam_s):
    return {"plain": [], "scalar": [mu_g, mu_s],
            "diag": [mu_g, mu_s, lam_g, lam_s]}[variant]


# ---------------------------------------------------------------------------
# the custom ops (CUDA tensors launch; fake tensors take the shape function)
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::fsgld_update_2d", mutates_args=(),
                         device_types="cuda")
def _update_2d_op(theta2d: torch.Tensor, g2d: torch.Tensor,
                  seeds: torch.Tensor, scalars: torch.Tensor,
                  seg_base: torch.Tensor, variant: str, dynamics: str,
                  r2d: Optional[torch.Tensor], mu_g: Optional[torch.Tensor],
                  mu_s: Optional[torch.Tensor], lam_g: Optional[torch.Tensor],
                  lam_s: Optional[torch.Tensor], block_rows: int,
                  chains: int) -> list[torch.Tensor]:
    seg_leaf = _one_leaf_tables(theta2d.device, seg_base.shape[0],
                                block_rows)[0]
    out = _launch("fsgld_update_2d", variant, dynamics, theta2d, g2d, r2d,
                  _sur_list(variant, mu_g, mu_s, lam_g, lam_s), seg_leaf,
                  seg_base, seeds, scalars, theta2d.shape[0] // chains,
                  block_rows, 1)
    return list(out) if dynamics == "sghmc" else [out]


@_update_2d_op.register_fake
def _(theta2d, g2d, seeds, scalars, seg_base, variant, dynamics, r2d, mu_g,
      mu_s, lam_g, lam_s, block_rows, chains):
    out = [torch.empty_like(theta2d)]
    return out + [torch.empty_like(r2d)] if dynamics == "sghmc" else out


@torch.library.custom_op("repro_torch::fsgld_update_packed",
                         mutates_args=("theta2d", "r2d"),
                         device_types="cuda")
def _update_packed_op(theta2d: torch.Tensor, g2d: torch.Tensor,
                      seeds: torch.Tensor, scalars: torch.Tensor,
                      seg_leaf: torch.Tensor, seg_base: torch.Tensor,
                      variant: str, dynamics: str,
                      r2d: Optional[torch.Tensor],
                      mu_g: Optional[torch.Tensor],
                      mu_s: Optional[torch.Tensor],
                      lam_g: Optional[torch.Tensor],
                      lam_s: Optional[torch.Tensor], block_rows: int,
                      chains: int) -> None:
    _launch("fsgld_update_packed", variant, dynamics, theta2d, g2d, r2d,
            _sur_list(variant, mu_g, mu_s, lam_g, lam_s), seg_leaf, seg_base,
            seeds, scalars, theta2d.shape[0] // chains, block_rows,
            int(seeds.shape[1]))


@_update_packed_op.register_fake
def _(theta2d, g2d, seeds, scalars, seg_leaf, seg_base, variant, dynamics,
      r2d, mu_g, mu_s, lam_g, lam_s, block_rows, chains):
    return None


@register_flop_formula([torch.ops.repro_torch.fsgld_update_2d,
                        torch.ops.repro_torch.fsgld_update_packed],
                       get_raw=True)
def _update_flops(*args, **kwargs) -> int:
    """The update is elementwise: its cost is the bytes it moves (the
    analyzer counts those), its matmul-family FLOPs 0."""
    return 0


# ---------------------------------------------------------------------------
# the two entries
# ---------------------------------------------------------------------------

def fsgld_update_packed(theta2d: torch.Tensor, g2d: torch.Tensor,
                        seeds: torch.Tensor, scalars: torch.Tensor, *,
                        variant: str = "plain", dynamics: str = "langevin",
                        r2d=None, mu_g=None, mu_s=None, lam_g=None,
                        lam_s=None, seg_leaf=None, seg_base=None,
                        block_rows: int = PACK_BLOCK_ROWS, chains: int = 1):
    """ONE launch updating every leaf of every chain in a packed buffer,
    in place.

    theta2d/g2d (and r2d for 'sghmc'): (chains * rows_total, 128) float32,
    rows_total = block_rows * len(seg_leaf). seeds: (chains, L) integer
    (uint32 values); scalars: (chains, L, SCALAR_COLS) float32. mu_g/lam_g:
    (rows_total, 128) shared; mu_s/lam_s: full height. seg_leaf[j] names
    the leaf of in-chain block j and seg_base[j] its first element's index
    within that leaf: int32 tensors on the operands' device (uploaded once
    per layout — ``PackedChains.tables``). Writes theta' into theta2d
    (and r' into r2d for 'sghmc') and returns theta2d (or (theta2d, r2d)).
    """
    bpc = len(seg_leaf)
    rows_total = block_rows * bpc
    if theta2d.shape[0] != chains * rows_total:
        raise ValueError(f"theta2d has {theta2d.shape[0]} rows, expected "
                         f"chains * block_rows * blocks = {chains} * "
                         f"{block_rows} * {bpc}")
    _check(variant, dynamics, theta2d, g2d, r2d, mu_g, mu_s, lam_g, lam_s,
           rows_total)
    num_leaves = int(seeds.shape[1])
    dev = theta2d.device
    if dev.type == "cpu" and not is_fake(theta2d):
        res = fsgld_update_packed_plain(
            theta2d, g2d, seeds, scalars, variant=variant, dynamics=dynamics,
            r2d=r2d, mu_g=mu_g, mu_s=mu_s, lam_g=lam_g, lam_s=lam_s,
            seg_leaf=seg_leaf, seg_base=seg_base, block_rows=block_rows,
            chains=chains)
        if dynamics == "langevin":
            return theta2d.copy_(res)
        return theta2d.copy_(res[0]), r2d.copy_(res[1])
    if dev.type != "cuda" and not is_fake(theta2d):
        raise RuntimeError(f"fsgld_update_packed runs on cuda or cpu "
                           f"tensors, not {dev.type}")
    _need("seeds", seeds, (chains, num_leaves), None, dev)
    _need("scalars", scalars, (chains, num_leaves, SCALAR_COLS),
          torch.float32, dev)
    _need("seg_leaf", seg_leaf, (bpc,), torch.int32, dev)
    _need("seg_base", seg_base, (bpc,), torch.int32, dev)
    _update_packed_op(theta2d, g2d, _seeds_i32(seeds), scalars.contiguous(),
                      seg_leaf, seg_base, variant, dynamics, r2d, mu_g, mu_s,
                      lam_g, lam_s, block_rows, chains)
    return (theta2d, r2d) if dynamics == "sghmc" else theta2d


def fsgld_update_2d(theta2d: torch.Tensor, g2d: torch.Tensor,
                    seed: torch.Tensor, scalars: torch.Tensor, *,
                    variant: str = "plain", dynamics: str = "langevin",
                    r2d=None, mu_g=None, mu_s=None, lam_g=None, lam_s=None,
                    block_rows: int = BLOCK_ROWS, chains: int = 1,
                    seg_base: Optional[torch.Tensor] = None):
    """The update on one leaf, chain-batched: rows [c*rows_c, (c+1)*rows_c)
    hold chain c. seed: (chains,) integer; scalars: (chains, SCALAR_COLS).
    Shared mu_g/lam_g are (rows_c, 128). The noise index of an element is
    its index within its chain, as in the Pallas kernel's ``_global_idx``.
    On the card this launches the packed kernel with a one-leaf segment
    table (seg_leaf = 0, seg_base[j] = j * br * 128). ``seg_base``
    (int32, one per block of ``block_rows`` rows of a chain, uint32
    values) gives each block's first index instead: a shard of a leaf
    passes its blocks' indices in the whole leaf."""
    rows = theta2d.shape[0]
    if rows % chains:
        raise ValueError(f"{rows} rows do not split into {chains} chains")
    rows_c = rows // chains
    br = min(block_rows, rows_c)
    if rows_c % br:
        raise ValueError(f"rows per chain {rows_c} is not a multiple of "
                         f"the block ({br} rows)")
    _check(variant, dynamics, theta2d, g2d, r2d, mu_g, mu_s, lam_g, lam_s,
           rows_c)
    dev = theta2d.device
    if dev.type == "cpu" and not is_fake(theta2d):
        return fsgld_update_2d_plain(
            theta2d, g2d, seed, scalars, variant=variant, dynamics=dynamics,
            r2d=r2d, mu_g=mu_g, mu_s=mu_s, lam_g=lam_g, lam_s=lam_s,
            chains=chains, seg_base=seg_base, block_rows=br)
    if dev.type != "cuda" and not is_fake(theta2d):
        raise RuntimeError(f"fsgld_update_2d runs on cuda or cpu tensors, "
                           f"not {dev.type}")
    _need("seed", seed, (chains,), None, dev)
    _need("scalars", scalars, (chains, SCALAR_COLS), torch.float32, dev)
    if seg_base is None:
        seg_base = _one_leaf_tables(dev, rows_c // br, br)[1]
    else:
        _need("seg_base", seg_base, (rows_c // br,), torch.int32, dev)
    out = _update_2d_op(theta2d, g2d, _seeds_i32(seed.reshape(chains, 1)),
                        scalars.reshape(chains, 1, SCALAR_COLS).contiguous(),
                        seg_base, variant, dynamics, r2d, mu_g, mu_s, lam_g,
                        lam_s, br, chains)
    return tuple(out) if dynamics == "sghmc" else out[0]
