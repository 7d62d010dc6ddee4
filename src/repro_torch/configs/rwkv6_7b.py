"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.

RWKV-6 "Finch": data-dependent diagonal decay linear recurrence, computed in
chunked linear-attention form. Sub-quadratic -> eligible for long_500k.
[arXiv:2404.05892]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,           # 64 heads x head_dim 64
    num_kv_heads=64,
    d_ff=14_336,
    vocab_size=65_536,
    head_dim=64,
    ffn_type="silu",
    layer_pattern=("rwkv",),
    source="arXiv:2404.05892",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512,
    )
