from repro_torch.sharding.rules import (  # noqa: F401
    batch_specs,
    cache_specs,
    logical_axes,
    param_shardings,
    param_specs,
    surrogate_specs,
)
