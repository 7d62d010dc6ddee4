"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.

Griffin: RG-LRU recurrent blocks + local (sliding-window) attention, pattern
(recurrent, recurrent, local-attn). Sub-quadratic -> eligible for long_500k.
[arXiv:2402.19427]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,          # 18 rglru + 8 swa (period-3 pattern, 26 = 3*8 + 2)
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,         # MQA on the local-attention layers
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    ffn_type="geglu",
    layer_pattern=("rglru", "rglru", "swa"),
    swa_window=2048,
    source="arXiv:2402.19427",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=256, num_heads=2, num_kv_heads=1,
        head_dim=128, d_ff=512, vocab_size=512, swa_window=64,
    )
