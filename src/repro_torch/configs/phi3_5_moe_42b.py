"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064.

MoE: 16 experts, top-2 routing. [hf:microsoft/Phi-3.5-MoE-instruct]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    head_dim=128,
    ffn_type="silu",
    moe=MoEConfig(num_experts=16, top_k=2),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2),
    )
