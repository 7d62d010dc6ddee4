"""Federation scenarios in PyTorch (counterpart of ``repro.fed``): non-IID
partitioners (host-side), communication schedules and compressed rounds
(lowered into the chain engine's rounds), and the named registry.
"""
from repro_torch.fed.compress import (Compression, make_compressor,
                                      make_flattener)
from repro_torch.fed.partition import PartitionSpec, partition
from repro_torch.fed.registry import SCENARIOS, get_scenario, scenario_names
from repro_torch.fed.schedule import CommSchedule
from repro_torch.fed.spec import Federation

__all__ = [
    "Federation", "PartitionSpec", "CommSchedule", "Compression",
    "partition", "make_compressor", "make_flattener",
    "SCENARIOS", "get_scenario", "scenario_names",
]
