"""Versioned draw-bank directories: the chain-to-server format
(counterpart of ``repro.checkpoint.draw_bank``; banks are
interchangeable with the JAX package's).

A draw bank is a directory of numbered single-draw checkpoints::

    bank/
      draw-000000/ {arrays.npz, manifest.json}   # repro-ckpt-v2 + DrawMeta
      draw-000001/ ...

Writers (``repro_torch.launch.train --draw-bank``, or :func:`save_draw`)
append draws ATOMICALLY (staged under a dot-prefixed temp name, then
renamed), so a server polling the directory between requests
(``repro_torch.serve.EnsembleServer.refresh``) never sees a half-written
draw. Readers take the FRESHEST K draws; every draw is fingerprint-checked
against the serving skeleton, and a bank of another arch or config is
REFUSED with a ValueError.

A legacy single-checkpoint directory (one ``manifest.json`` at the top
level, as ``launch.train --ckpt`` writes) reads as a one-draw bank.
"""
from __future__ import annotations

import os
import re
import warnings
from typing import Any, Iterator, List, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.checkpoint.np_checkpoint import (CorruptCheckpointError,
                                                  DrawMeta, read_meta,
                                                  restore, save,
                                                  tree_fingerprint)

PyTree = Any

_DRAW_RE = re.compile(r"^draw-(\d{6})$")


def _draw_dirname(i: int) -> str:
    return f"draw-{i:06d}"


def list_draws(bank_dir: str) -> List[str]:
    """Complete draw paths, oldest first. A draw is complete once its
    manifest exists (the rename in save_draw publishes the manifest with
    the arrays)."""
    if not os.path.isdir(bank_dir):
        return []
    out = []
    for name in sorted(os.listdir(bank_dir)):
        m = _DRAW_RE.match(name)
        path = os.path.join(bank_dir, name)
        if m and os.path.exists(os.path.join(path, "manifest.json")):
            out.append(path)
    return out


def save_draw(bank_dir: str, tree: PyTree, meta: DrawMeta, *,
              step: int = 0) -> str:
    """Append one draw to the bank (atomic: staged + renamed). Returns
    the draw's final path."""
    os.makedirs(bank_dir, exist_ok=True)
    existing = [int(_DRAW_RE.match(n).group(1))
                for n in os.listdir(bank_dir) if _DRAW_RE.match(n)]
    idx = max(existing) + 1 if existing else 0
    final = os.path.join(bank_dir, _draw_dirname(idx))
    tmp = os.path.join(bank_dir, f".tmp-{_draw_dirname(idx)}")
    save(tmp, tree, step=step, meta=meta)
    os.rename(tmp, final)
    return final


def iter_bank(bank_dir: str, like: PyTree, *, k: Optional[int] = None,
              expect_arch: Optional[str] = None
              ) -> Iterator[Tuple[PyTree, Optional[DrawMeta]]]:
    """The freshest ``k`` servable draws (all when None), one at a time
    and FRESHEST FIRST, as (tree of host tensors, meta): a caller that
    moves each draw elsewhere holds one draw on the host at a time.

    Refusal contract: every draw's structural fingerprint must match
    ``like`` (the serving skeleton; meta tensors do), and when
    ``expect_arch`` is given every DrawMeta.arch must agree; a mismatch
    raises ValueError.

    Degradation contract: a CORRUPT draw (torn write, truncated or
    garbled arrays, content-hash mismatch) is skipped with a warning and
    an OLDER healthy draw backfills. Only when the directory holds no
    servable draw does this raise, naming the directory and every
    per-draw reason."""
    paths = list_draws(bank_dir)
    if not paths:
        # legacy fallback: the directory IS a single old-style checkpoint
        if os.path.exists(os.path.join(bank_dir, "manifest.json")):
            paths = [bank_dir]
        elif not os.path.isdir(bank_dir):
            raise ValueError(
                f"no draws in bank {bank_dir!r}: the directory does not "
                "exist (pass a draw-bank dir written by "
                "repro_torch.launch.train --draw-bank, or a legacy "
                "single-checkpoint dir)")
        else:
            raise ValueError(
                f"no draws in bank {bank_dir!r}: the directory exists but "
                "holds no complete draw-NNNNNN checkpoint and no legacy "
                "top-level manifest.json — the writer may not have "
                "finished its first draw yet")
    if k is not None and k > len(paths):
        raise ValueError(f"bank {bank_dir!r} holds {len(paths)} draw(s), "
                         f"{k} requested")

    want_k = k if k is not None else len(paths)
    want = tree_fingerprint(like)
    n, bad = 0, []
    # walk freshest -> oldest, backfilling past corrupt draws until the
    # requested ensemble size is met (or the bank is exhausted)
    for p in reversed(paths):
        if n == want_k:
            break
        try:
            meta = read_meta(p)
        except CorruptCheckpointError as e:
            bad.append((p, str(e)))
            continue
        if meta is not None and meta.config_hash is not None \
                and meta.config_hash != want:
            raise ValueError(
                f"draw bank refused: {p} was drawn from a different "
                f"arch/config (hash {meta.config_hash} != serving "
                f"skeleton {want}"
                + (f"; bank arch={meta.arch!r}" if meta.arch else "") + ")")
        if expect_arch is not None and meta is not None \
                and meta.arch is not None and meta.arch != expect_arch:
            raise ValueError(
                f"draw bank refused: {p} is arch {meta.arch!r}, "
                f"server expects {expect_arch!r}")
        try:
            tree, _, _ = restore(p, like)
        except CorruptCheckpointError as e:
            bad.append((p, str(e)))
            continue
        except ValueError as e:
            raise ValueError(f"draw bank refused: {e}") from e
        n += 1
        yield tree, meta
        del tree
    if n == 0:
        reasons = "; ".join(f"{p}: {r}" for p, r in bad)
        raise ValueError(
            f"no servable draws in bank {bank_dir!r}: all {len(paths)} "
            f"present draw(s) are corrupt ({reasons})")
    if bad:
        warnings.warn(
            f"bank {bank_dir!r}: skipped {len(bad)} corrupt draw(s) "
            f"({'; '.join(p for p, _ in bad)}); serving {n} of "
            f"{want_k} requested draw(s)")


def load_bank(bank_dir: str, like: PyTree, *, k: Optional[int] = None,
              expect_arch: Optional[str] = None
              ) -> Tuple[PyTree, List[Optional[DrawMeta]]]:
    """Load the freshest ``k`` draws (all when None) STACKED along a new
    leading draw axis on the host (the caller chooses the device), under
    :func:`iter_bank`'s refusal and degradation contracts. Returns
    (stacked tree with (K, ...) leaves, per-draw metas oldest to
    freshest; None for legacy draws)."""
    draws, metas = [], []
    for tree, meta in iter_bank(bank_dir, like, k=k,
                                expect_arch=expect_arch):
        draws.append(tree)
        metas.append(meta)
    draws.reverse()            # oldest -> freshest, the documented order
    metas.reverse()
    stacked = tu.tree_map(lambda *ls: torch.stack(ls), *draws)
    return stacked, metas
