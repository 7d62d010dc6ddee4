"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Pruned Nemotron. [arXiv:2407.14679]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=256_000,
    head_dim=128,
    ffn_type="silu",
    source="arXiv:2407.14679",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
    )
