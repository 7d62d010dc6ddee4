"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.

GeGLU FFN, head_dim=256 (q/kv projections 3072 -> 4096). [arXiv:2403.08295]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24_576,
    vocab_size=256_000,
    head_dim=256,
    ffn_type="geglu",
    source="arXiv:2403.08295",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512,
    )
