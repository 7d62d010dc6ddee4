"""Federation scenarios in PyTorch (counterpart of ``repro.fed``): non-IID
partitioners (host-side), communication schedules and compressed rounds
(lowered into the chain engine's rounds), the named registry, and the
streamed client axis (lazy client sources, resident-window planning, the
host-tier hierarchical reductions).
"""
from repro_torch.fed.compress import (Compression, make_compressor,
                                      make_flattener)
from repro_torch.fed.hierarchy import (hierarchical_mean, hierarchical_sum,
                                       normalize_hierarchical)
from repro_torch.fed.partition import (PartitionedSource, PartitionSpec,
                                       SyntheticClientSource,
                                       is_client_source, partition,
                                       resolve_shard_probs,
                                       shard_prob_preset_names)
from repro_torch.fed.registry import SCENARIOS, get_scenario, scenario_names
from repro_torch.fed.schedule import (CommSchedule, StreamWindow,
                                      plan_stream, replay_sids)
from repro_torch.fed.spec import Federation, Stream

__all__ = [
    "Federation", "Stream", "PartitionSpec", "CommSchedule", "Compression",
    "partition", "make_compressor", "make_flattener",
    "SCENARIOS", "get_scenario", "scenario_names",
    "resolve_shard_probs", "shard_prob_preset_names",
    "SyntheticClientSource", "PartitionedSource", "is_client_source",
    "StreamWindow", "replay_sids", "plan_stream",
    "hierarchical_sum", "hierarchical_mean", "normalize_hierarchical",
]
