"""whisper-large-v3 [audio] — 32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.

Encoder-decoder; the mel-spectrogram + conv frontend is a STUB per assignment —
input_specs() provides 1500 precomputed frame embeddings. Decoder layers do
self-attention + cross-attention to the encoder output. [arXiv:2212.04356]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,          # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,        # MHA (no GQA in whisper)
    d_ff=5120,
    vocab_size=51_866,
    head_dim=64,
    ffn_type="gelu",
    layer_pattern=("xattn",),  # audio decoder layer = self-attn + cross-attn
    source="arXiv:2212.04356",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, encoder_seq=32, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
    )
