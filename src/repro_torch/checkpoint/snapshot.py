"""Preemption-safe run snapshots: the whole carry of the host loop,
atomically (counterpart of ``repro.checkpoint.snapshot``).

A snapshot directory holds numbered checkpoints of EVERYTHING the
engine carries across rounds: chain state, the generator's state, the
federation carry (client ids, compression reference and error), the
health words and the trace collected so far::

    snaps/
      snap-000004/ {arrays.npz, manifest.json}   # after round 4
      snap-000008/ ...

Each snapshot is written through the v2 checkpoint layer into a FRESH
``snap-{round:06d}`` directory, so publishing is one rename. Readers walk
newest to oldest, skipping corrupt snapshots with a warning, so losing
the latest write costs at most one snapshot interval, never the run.

The payload is a flat dict of named tensors (``repro_torch.core.engine``
decides the keys); this module guarantees atomicity, pruning and
newest-valid selection.
"""
from __future__ import annotations

import os
import re
import shutil
import warnings
from typing import Any, Dict, Optional, Tuple

from repro_torch.checkpoint.np_checkpoint import (CorruptCheckpointError,
                                                  restore, save)
from repro_torch.obs import trace as obs_trace

_SNAP_RE = re.compile(r"^snap-(\d{6})$")


def _snap_dirname(r: int) -> str:
    return f"snap-{r:06d}"


def list_snapshots(snap_dir: str):
    """(rounds_done, path) pairs of complete snapshots, oldest first."""
    if not os.path.isdir(snap_dir):
        return []
    out = []
    for name in sorted(os.listdir(snap_dir)):
        m = _SNAP_RE.match(name)
        path = os.path.join(snap_dir, name)
        if m and os.path.exists(os.path.join(path, "manifest.json")):
            out.append((int(m.group(1)), path))
    return out


def save_snapshot(snap_dir: str, payload: Dict[str, Any], *,
                  rounds_done: int, keep: int = 2) -> str:
    """Atomically publish the carry after ``rounds_done`` rounds, then
    prune to the newest ``keep`` snapshots. Returns the snapshot path."""
    with obs_trace.span("snapshot.save", round=int(rounds_done)):
        os.makedirs(snap_dir, exist_ok=True)
        final = os.path.join(snap_dir, _snap_dirname(rounds_done))
        if os.path.exists(final):      # re-running the same segment
            shutil.rmtree(final)
        save(final, payload, step=rounds_done)
        for _, path in list_snapshots(snap_dir)[:-keep]:
            shutil.rmtree(path, ignore_errors=True)
    return final


def latest_snapshot(snap_dir: str, like: Dict[str, Any]
                    ) -> Tuple[Optional[Dict[str, Any]], int]:
    """The newest VALID snapshot restored into ``like``'s structure (host
    tensors), as (payload, rounds_done), or (None, 0) when the directory
    holds none. Corrupt snapshots are skipped with a warning; a
    structural mismatch (another run's config) raises."""
    with obs_trace.span("snapshot.restore", dir=snap_dir):
        for _, path in reversed(list_snapshots(snap_dir)):
            try:
                payload, step, _ = restore(path, like)
            except CorruptCheckpointError as e:
                warnings.warn(f"skipping corrupt snapshot {path!r}: {e}")
                obs_trace.event("snapshot.corrupt", path=path, error=str(e))
                continue
            return payload, int(step)
    return None, 0
