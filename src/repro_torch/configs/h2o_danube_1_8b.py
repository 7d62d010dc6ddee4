"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

llama+mistral mix with sliding-window attention. [arXiv:2401.16818]
Sub-quadratic via SWA -> eligible for long_500k decode.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    head_dim=80,
    layer_pattern=("swa",),
    swa_window=4096,
    ffn_type="silu",
    source="arXiv:2401.16818",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, swa_window=64,
    )
