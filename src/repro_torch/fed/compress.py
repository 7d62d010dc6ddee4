"""Compressed communication operators for round-boundary payloads
(counterpart of ``repro.fed.compress``).

The payload is a chain's parameter DELTA since its last communication. At
a communication round the server applies

    upd   = (theta - ref) + err        # delta + error feedback
    dhat  = C(upd)                     # the compressed payload
    ref'  = ref + dhat                 # the server's view
    err'  = upd - dhat                 # the error-feedback residual
    theta <- ref'                      # the chain continues from it

ELF's *dual* leg compresses the server->client broadcast the same way,
against the shared reference with its own residual ``derr``;
``direction`` picks the legs: 'primal' (client->server), 'dual'
(server->client) or 'bidir' (both, each with its own residual).

The operators act on (C, P) float32 chain-major flat matrices on the
device. The stochastic ones take (C, P) uniforms in [0, 1) drawn by the
engine (``core.engine.draw_round``), not a key.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as tu

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Compression:
    """Declarative round-boundary payload compression.

    kind:
      'none'  — exact exchange (the identity);
      'topk'  — keep the ``frac`` largest-|.| coordinates per chain (ties
                at the threshold are all kept);
      'randk' — keep each coordinate with probability ``frac``, rescaled
                by 1/frac (unbiased);
      'qsgd'  — stochastic rounding of |upd| / max|upd| to 2^bits - 1
                levels with a per-chain float32 scale (unbiased).
    ``error_feedback`` keeps the residual state. ``direction``: 'primal',
    'dual' or 'bidir' (see the module docstring).
    """
    kind: str = "none"
    frac: float = 0.01
    bits: int = 8
    error_feedback: bool = True
    direction: str = "primal"

    def __post_init__(self):
        if self.kind not in ("none", "topk", "randk", "qsgd"):
            raise ValueError(f"unknown compression kind {self.kind!r}")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {self.frac}")
        if not 1 <= self.bits <= 16:
            raise ValueError(f"bits must be in [1, 16], got {self.bits}")
        if self.direction not in ("primal", "dual", "bidir"):
            raise ValueError(f"unknown direction {self.direction!r}")

    @property
    def identity(self) -> bool:
        return self.kind == "none"

    @property
    def stochastic(self) -> bool:
        """The operator consumes (C, P) uniforms."""
        return self.kind in ("randk", "qsgd")

    @property
    def use_primal(self) -> bool:
        """Client->server uploads go through the operator."""
        return self.kind != "none" and self.direction in ("primal", "bidir")

    @property
    def use_dual(self) -> bool:
        """Server->client broadcasts go through the operator."""
        return self.kind != "none" and self.direction in ("dual", "bidir")

    def payload_bytes(self, dim: int) -> float:
        """Estimated bytes of ONE compressed payload for a dim-P chain."""
        if self.kind == "none":
            return 4.0 * dim
        if self.kind in ("topk", "randk"):
            k = max(1, int(round(self.frac * dim)))
            return 8.0 * k  # float32 value + int32 index per coordinate
        return dim * self.bits / 8.0 + 4.0  # qsgd: levels + float32 scale

    def bytes_per_round(self, dim: int) -> float:
        """Estimated bytes per chain per communication round, BOTH
        directions: compressed legs report the payload, uncompressed legs
        4 bytes per coordinate."""
        up = self.payload_bytes(dim) if self.use_primal else 4.0 * dim
        down = self.payload_bytes(dim) if self.use_dual else 4.0 * dim
        return up + down


def make_flattener(thetas: PyTree):
    """(C, ...)-leaf pytree <-> (C, P) float32 flat matrix. ``unflatten``
    casts each slice back to its leaf's storage dtype. Returns (flatten,
    unflatten, P)."""
    leaves, treedef = tu.flatten(thetas)
    shapes = [tuple(l.shape[1:]) for l in leaves]
    sizes = [int(l[0].numel()) for l in leaves]
    dtypes = [l.dtype for l in leaves]

    def flatten(tree):
        return torch.cat([l.reshape(l.shape[0], -1).to(torch.float32)
                          for l in tu.leaves(tree)], dim=1)

    def unflatten(flat):
        out, off = [], 0
        for shp, sz, dt in zip(shapes, sizes, dtypes):
            out.append(flat[:, off:off + sz]
                       .reshape((flat.shape[0],) + shp).to(dt))
            off += sz
        return tu.unflatten(treedef, out)

    return flatten, unflatten, sum(sizes)


def make_compressor(spec: Compression, dim: int):
    """Lower a :class:`Compression` to ``compress(upd, u) -> dhat`` over
    (C, P) payloads; ``u``: (C, P) uniforms for 'randk'/'qsgd', else
    unused (None)."""
    if spec.kind == "none":
        return lambda upd, u: upd
    if spec.kind == "topk":
        k = max(1, int(round(spec.frac * dim)))

        def topk(upd, u):
            mag = upd.abs()
            thr = torch.topk(mag, k, dim=1).values[:, -1:]   # (C, 1)
            return torch.where(mag >= thr, upd, 0.0)

        return topk
    if spec.kind == "randk":
        def randk(upd, u):
            return torch.where(u < spec.frac, upd / spec.frac, 0.0)

        return randk

    levels = float(2 ** spec.bits - 1)

    def qsgd(upd, u):
        scale = upd.abs().amax(dim=1, keepdim=True)          # (C, 1)
        y = upd.abs() / scale.clamp_min(1e-30) * levels
        lo = torch.floor(y)
        lvl = lo + (u < (y - lo)).to(upd.dtype)
        return torch.where(scale > 0.0,
                           torch.sign(upd) * scale * lvl / levels, 0.0)

    return qsgd
