"""Deterministic fault injectors (counterpart of ``repro.testing.chaos``).

Two families, matching the two places the runtime can break:

  * :class:`ChaosSpec` — faults the chain engine applies per round
    (``MeshChainEngine.run(..., chaos=spec)``), like a federation
    scenario: NaN-poisoned states on chosen chains at chosen rounds (the
    observable effect of a client returning a NaN gradient: the chain's
    post-round state is NaN), and NaN-corrupted compressed payloads at
    the round boundary (the server view a chain continues from goes
    bad). Fully deterministic: the fault set is static configuration,
    not randomness, so a chaos run is reproducible bit for bit and
    comparable chain by chain against a fault-free run.

  * Host-side IO injectors — :func:`corrupt_draw`, :func:`truncate_file`
    and :func:`flaky_io` break the checkpoint and draw-bank layer the way
    preemptions and flaky filesystems do: garbled or truncated array
    files (torn writes), and reads that fail transiently N times before
    succeeding (the retry-with-backoff path of ``repro_torch.serve``).

The engine does NOT import this module: it duck-types the spec (static
tuples of chain and round indices), so production code carries no
test-harness dependency.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Static fault plan, applied by the engine's host loop (hashable,
    like the JAX package's).

    nan_chains / nan_rounds: the cross product of these chain indices
      and (absolute) round indices gets its post-round chain state
      NaN-poisoned — the deterministic stand-in for a NaN gradient on
      that client at that round.
    payload_nan_chains / payload_nan_rounds: with a compressed
      federation scenario active, the compressed payload (the delta the
      server applies) of these chains is NaN-corrupted at these
      communication rounds before the server view updates.
    """
    nan_chains: tuple = ()
    nan_rounds: tuple = ()
    payload_nan_chains: tuple = ()
    payload_nan_rounds: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "nan_chains",
                           tuple(int(c) for c in self.nan_chains))
        object.__setattr__(self, "nan_rounds",
                           tuple(int(r) for r in self.nan_rounds))
        object.__setattr__(self, "payload_nan_chains",
                           tuple(int(c) for c in self.payload_nan_chains))
        object.__setattr__(self, "payload_nan_rounds",
                           tuple(int(r) for r in self.payload_nan_rounds))

    @property
    def poisons_state(self) -> bool:
        return bool(self.nan_chains) and bool(self.nan_rounds)

    @property
    def poisons_payload(self) -> bool:
        return bool(self.payload_nan_chains) and \
            bool(self.payload_nan_rounds)

    @property
    def active(self) -> bool:
        return self.poisons_state or self.poisons_payload


# ---------------------------------------------------------------------------
# host-side IO fault injectors
# ---------------------------------------------------------------------------

def truncate_file(path: str, keep_bytes: int = 16) -> str:
    """Truncate a file to its first ``keep_bytes`` bytes — the on-disk
    shape of a write preempted mid-flush. Returns the path."""
    with open(path, "rb") as f:
        head = f.read(keep_bytes)
    with open(path, "wb") as f:
        f.write(head)
    return path


def corrupt_draw(draw_dir: str, mode: str = "truncate") -> str:
    """Break one draw/checkpoint directory the way real faults do.

    mode:
      'truncate' — cut arrays.npz short (torn write; np.load fails or
                   the manifest's content hash mismatches).
      'garbage'  — overwrite arrays.npz with non-npz bytes.
      'missing'  — delete arrays.npz, keep the manifest (the draw looks
                   complete to the directory listing).
    Returns ``draw_dir``.
    """
    arrays = os.path.join(draw_dir, "arrays.npz")
    if mode == "truncate":
        truncate_file(arrays)
    elif mode == "garbage":
        with open(arrays, "wb") as f:
            f.write(b"not an npz archive, chaos was here")
    elif mode == "missing":
        os.remove(arrays)
    else:
        raise ValueError(mode)
    return draw_dir


@contextlib.contextmanager
def flaky_io(n_failures: int, exc: type = OSError,
             match: str = ".npz"):
    """Make ``open()`` raise ``exc`` for the first ``n_failures`` READ
    opens whose path contains ``match`` (writes and unrelated paths
    always pass through) — deterministic transient-IO chaos for the
    retry-with-backoff reader paths. Yields a one-element list holding
    the number of injected failures so far."""
    import builtins
    orig, count = builtins.open, [0]

    def fake_open(file, mode="r", *a, **k):
        if count[0] < n_failures and "r" in mode \
                and isinstance(file, (str, os.PathLike)) \
                and match in os.fspath(file):
            count[0] += 1
            raise exc(f"chaos: injected transient IO failure "
                      f"{count[0]}/{n_failures} on {os.fspath(file)}")
        return orig(file, mode, *a, **k)

    builtins.open = fake_open
    try:
        yield count
    finally:
        builtins.open = orig
