"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

Cross-attention image layers every 5th layer; the vision encoder is a STUB per
assignment — input_specs() provides precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision, 90B variant]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    head_dim=128,
    ffn_type="silu",
    layer_pattern=("attn", "attn", "attn", "attn", "xattn"),
    num_patches=6404,  # 4 tiles x 1601 patches (560px / 14 + cls)
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, num_patches=16,
        layer_pattern=("attn", "xattn"),
    )
