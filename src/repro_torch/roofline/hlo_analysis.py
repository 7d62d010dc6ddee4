"""Roofline inputs counted from the aten op stream (counterpart of
``repro.roofline.hlo_analysis``).

The reference parses XLA's optimized HLO text. The port has no HLO: it
runs eagerly (on the card, or on fake tensors in the dry run), so the
three roofline inputs are counted op by op as the ops run, by a
``TorchDispatchMode`` (``OpCounter``). The mode passes DTensor ops on to
DTensor and counts the ops DTensor issues on each rank's LOCAL shards,
so every number is per device:

  * FLOPs            -- matmul-family ops (mm, addmm, bmm, baddbmm, the
                        convolutions, SDPA): 2 * |out| * K, from
                        ``torch.utils.flop_counter``'s formulas; the
                        port's custom ops by their registered formulas
                        (flash attention: the tiles the kernel visits;
                        the update: 0). Elementwise FLOPs are ignored,
                        as in the reference.
  * HBM bytes        -- per op, operand + result bytes (and the operands
                        a custom op writes in place), the reference's
                        approximation; in eager mode every op does read
                        its operands and write its result. View and
                        metadata ops move nothing and are skipped.
  * collective bytes -- the ``_c10d_functional`` collectives DTensor
                        issues (all_gather_into_tensor, reduce_scatter,
                        all_reduce, all_to_all_single, ...), result
                        bytes by kind.

There is no scan in the port's models (layers are a Python loop, each
iteration its own ops), so every loop is counted as many times as it
runs: ``flops`` and ``static_flops`` are the same number.
"""
from __future__ import annotations

import collections
from typing import Callable

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# ops that move no bytes: views, aliases, metadata, waits
_FREE = {"detach", "alias", "view", "_unsafe_view", "reshape", "expand",
         "as_strided", "t", "transpose", "permute", "select", "slice",
         "unsqueeze", "squeeze", "split", "split_with_sizes", "chunk",
         "unbind", "narrow", "diagonal", "unfold", "view_as_real",
         "view_as_complex", "lift_fresh", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "wait_tensor", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "_local_scalar_dense",
         "set_", "resize_", "record_stream"}

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor_type(tp) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(tp, DTensor)


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, HBM bytes and collective bytes of the ops that run
    while it is active (``with OpCounter() as c: ...``; ``c.result()``).
    Per op name the totals are kept for ``breakdown``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = collections.defaultdict(float)
        self.by_op = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0])
        self._fake_on_entry = None
        self.last = None        # the op dispatched last (a failure's op)

    def __enter__(self):
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.last = func
        if any(_is_dtensor_type(tp) for tp in types):
            return NotImplemented          # DTensor runs it on the shards
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs ops under a fake mode of
        # its own: those are bookkeeping, not the rank's work
        if active_fake_mode() is self._fake_on_entry:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        ns = func.namespace
        row = self.by_op[f"{ns}.{name}"]
        row[0] += 1
        if ns == "_c10d_functional" and name in _COLLECTIVES:
            b = sum(_nbytes(t) for t in _tensors(out))
            self.collective_bytes[_COLLECTIVES[name]] += b
            row[3] += b
            return
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            row[1] += f
        if name in _FREE or func.is_view or ns in ("_c10d_functional",
                                                    "prim"):
            return
        b = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        b += sum(_nbytes(t) for t in _tensors(out))
        for i, a in enumerate(func._schema.arguments):
            # an op writing an operand in place writes it back
            if a.alias_info is not None and a.alias_info.is_write \
                    and ns != "aten" and i < len(args) \
                    and isinstance(args[i], torch.Tensor):
                b += _nbytes(args[i])
        self.hbm_bytes += b
        row[2] += b

    def result(self) -> dict:
        """The reference analyzer's keys (per device)."""
        coll = dict(self.collective_bytes)
        return {"flops": self.flops, "static_flops": self.flops,
                "static_hbm_bytes": self.hbm_bytes,
                "static_collective_bytes": coll,
                "static_collective_total": sum(coll.values())}

    def breakdown(self, top: int = 25) -> dict:
        """Top ops by HBM bytes, FLOPs and collective bytes: rows of
        (amount, calls, op name)."""
        rows = [(v, k) for k, v in self.by_op.items()]

        def ranked(i):
            r = sorted(((v[i], v[0], k) for v, k in rows if v[i]),
                       reverse=True)
            return r[:top]
        return {"traffic": ranked(2), "flops": ranked(1),
                "collectives": ranked(3)}


def analyze(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter``: (its output,
    the counter's ``result()``)."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.result()
