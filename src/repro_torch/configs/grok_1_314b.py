"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.

MoE: 8 experts, top-2 routing. [hf:xai-org/grok-1]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    head_dim=128,
    ffn_type="geglu",
    moe=MoEConfig(num_experts=8, top_k=2),
    param_dtype="float32",
    source="hf:xai-org/grok-1",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2),
    )
