"""Dense attention transformers for serving (counterpart of
``repro.models``)."""
from repro_torch.models.model import (  # noqa: F401
    ACT_DTYPE,
    broadcast_cache,
    decode_step,
    ensemble_decode_step,
    init_cache,
    init_params,
    param_layout,
    prefill_with_cache,
    serving_params,
)
