"""The language models of every family (dense, MoE, RG-LRU hybrid, RWKV-6,
the vlm's gated cross-attention and the audio encoder-decoder): the
sampling path's log-likelihood and serving (counterpart of
``repro.models``)."""
from repro_torch.models.model import (  # noqa: F401
    ACT_DTYPE,
    broadcast_cache,
    chunked_log_lik,
    decode_step,
    encoder_forward,
    encoder_stream,
    ensemble_decode_step,
    forward,
    init_cache,
    init_leaves,
    init_params,
    log_lik_fn,
    param_layout,
    prefill_with_cache,
    serving_cast,
    serving_params,
)
