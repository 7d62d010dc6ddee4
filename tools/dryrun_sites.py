"""Where a dry-run combination's FLOPs, collective bytes and peak memory
come from: ``repro_torch.launch.dryrun`` on one (arch, shape, pod) with
the op counter's rows split by (op, output shape, the innermost model
lines that issued it), and the largest tensors alive at the step's
high-water mark of op outputs.

    PYTHONPATH=src python tools/dryrun_sites.py --arch llama-3.2-vision-90b \\
        --shape train_4k [--multi-pod] [--top 15] [--live 15]

Prints the dry run's own OK line, then the top rows by FLOPs and by
collective bytes ("calls, amount, op, output shape, sites") and, with
``--live N``, the N largest op outputs alive when the live total of op
outputs peaked (their op, shape, dtype and sites; the arguments are not
counted there, ``MemTracker``'s peak in the OK line includes them). CPU
only, like the dry run; a fake world is process-global, so run it in a
process of its own.
"""
from __future__ import annotations

import argparse
import collections
import sys
import traceback
import weakref

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.launch import dryrun
from repro_torch.roofline import hlo_analysis as H


def _sites(depth: int = 2) -> tuple:
    """The innermost ``depth`` frames of repro_torch's models and kernels
    on the stack, as 'file:line'."""
    return tuple(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                 for f in traceback.extract_stack()
                 if "/repro_torch/models/" in f.filename
                 or "/repro_torch/kernels/" in f.filename)[-depth:]


class Sites:
    """Wraps ``OpCounter._count`` while active: per (op, shape, sites)
    the FLOPs and collective bytes, and the live op outputs."""

    def __init__(self, live_big: int):
        self.rows = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self.live = {}
        self.cur = self.peak = 0
        self.at_peak = []
        self.live_big = live_big

    def _free(self, key, n):
        if self.live.pop(key, None) is not None:
            self.cur -= n

    def count(self, counter, func, args, kwargs, out, count):
        flops, coll = counter.flops, sum(counter.collective_bytes.values())
        count(counter, func, args, kwargs, out)
        df = counter.flops - flops
        dc = sum(counter.collective_bytes.values()) - coll
        name = f"{func.namespace}.{func.overloadpacket.__name__}"
        if df or dc:
            row = self.rows[(name, tuple(getattr(out, "shape", ())),
                             _sites())]
            row[0] += 1
            row[1] += df
            row[2] += dc
        # an output that shares an input's storage (a view, an op in
        # place) is no new memory: an op output's is tracked already, an
        # argument's is not counted
        inputs = {id(a.untyped_storage()) for a in tree_flatten(
            (args, kwargs))[0] if isinstance(a, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.live or key in inputs:
                continue
            n = st.nbytes()
            self.live[key] = (n, name, tuple(t.shape), str(t.dtype),
                              _sites(3) if n >= self.live_big else ())
            self.cur += n
            weakref.finalize(st, self._free, key, n)
            if self.cur > self.peak:
                self.peak = self.cur
                if n >= self.live_big or not self.at_peak:
                    self.at_peak = sorted(self.live.values(),
                                          key=lambda v: -v[0])[:64]

    def top(self, i: int, n: int):
        return sorted(((v[i], v[0], k) for k, v in self.rows.items()
                       if v[i]), reverse=True)[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--live", type=int, default=0,
                    help="list the N largest op outputs alive at the peak")
    args = ap.parse_args(argv)
    sites = Sites(live_big=32 * 2 ** 20)
    count = H.OpCounter._count
    H.OpCounter._count = lambda self, *a: sites.count(self, *a, count)
    try:
        rc = dryrun.main(["--arch", args.arch, "--shape", args.shape]
                         + (["--multi-pod"] if args.multi_pod else []))
    finally:
        H.OpCounter._count = count
    for title, i in (("FLOPs", 1), ("collective bytes", 2)):
        print(f"top {title}: calls, amount, op, output shape, sites")
        for amount, calls, (op, shape, where) in sites.top(i, args.top):
            print(f"  {calls:6d} {amount:.4e} {op} {shape} "
                  f"{' < '.join(where)}")
    if args.live:
        print(f"live op outputs at their peak {sites.peak / 2 ** 30:.2f} "
              "GiB (arguments not counted): GiB, op, shape, dtype, sites")
        for n, op, shape, dtype, where in sites.at_peak[:args.live]:
            print(f"  {n / 2 ** 30:8.3f} {op} {shape} {dtype} "
                  f"{' < '.join(where)}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
