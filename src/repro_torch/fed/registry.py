"""Named federation scenarios: the paper's configurations as a registry
(counterpart of ``repro.fed.registry``, the same names in the same order).
``get_scenario`` takes a name or passes a :class:`Federation` through, so
every entry point takes either.
"""
from __future__ import annotations

import difflib

from repro_torch.fed.compress import Compression
from repro_torch.fed.partition import PartitionSpec
from repro_torch.fed.schedule import CommSchedule
from repro_torch.fed.spec import Federation

SCENARIOS = {
    # the control: no partition, every-round exact communication
    "identity": Federation(),
    # partition axis (host-side; data given to the facade is POOLED)
    "iid": Federation(partition=PartitionSpec(kind="iid")),
    "dirichlet-0.1": Federation(
        partition=PartitionSpec(kind="dirichlet", alpha=0.1)),
    "dirichlet-100": Federation(
        partition=PartitionSpec(kind="dirichlet", alpha=100.0)),
    "quantity-0.5": Federation(
        partition=PartitionSpec(kind="quantity", alpha=0.5)),
    "covariate": Federation(partition=PartitionSpec(kind="covariate")),
    # communication-schedule axis
    "delayed-5x": Federation(schedule=CommSchedule(delay=5)),
    "delayed-10x": Federation(schedule=CommSchedule(delay=10)),
    "delayed-100x": Federation(schedule=CommSchedule(delay=100)),
    "partial-50%": Federation(schedule=CommSchedule(participation=0.5)),
    "straggler-10%": Federation(
        schedule=CommSchedule(straggler_prob=0.1)),
    # compressed-rounds axis (error feedback on)
    "topk-1%": Federation(compression=Compression(kind="topk", frac=0.01)),
    "randk-10%": Federation(
        compression=Compression(kind="randk", frac=0.10)),
    "qsgd-8bit": Federation(compression=Compression(kind="qsgd", bits=8)),
    # ELF leg selection: dual compresses the server->client broadcast,
    # bidir both legs with their own error-feedback state
    "elf-dual-topk-1%": Federation(
        compression=Compression(kind="topk", frac=0.01, direction="dual")),
    "elf-bidir-topk-1%": Federation(
        compression=Compression(kind="topk", frac=0.01, direction="bidir")),
    "elf-bidir-randk-10%": Federation(
        compression=Compression(kind="randk", frac=0.10,
                                direction="bidir")),
    "elf-bidir-qsgd-8bit": Federation(
        compression=Compression(kind="qsgd", bits=8, direction="bidir")),
}


def scenario_names() -> tuple:
    """All registry names, in a stable order."""
    return tuple(SCENARIOS)


def get_scenario(name_or_spec) -> Federation:
    """Resolve a registry name to its spec; pass a Federation through."""
    if isinstance(name_or_spec, Federation):
        return name_or_spec
    try:
        return SCENARIOS[name_or_spec]
    except (KeyError, TypeError):
        near = difflib.get_close_matches(str(name_or_spec),
                                         scenario_names(), n=1)
        hint = f" (did you mean {near[0]!r}?)" if near else ""
        raise KeyError(
            f"unknown federation scenario {name_or_spec!r}{hint}; "
            f"available: {', '.join(scenario_names())}") from None
