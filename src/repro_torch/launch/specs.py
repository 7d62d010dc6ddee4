"""Meta-device stand-ins for every model input (counterpart of
``repro.launch.specs``, whose ``jax.ShapeDtypeStruct``s these are): the
dry run never allocates. Modality frontends (vlm / audio) enter as
precomputed patch / frame embeddings, as in the reference."""
from __future__ import annotations

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import init_cache, param_layout
from repro_torch.models.model import ACT_DTYPE


def sds(shape, dtype) -> torch.Tensor:
    """A (shape, dtype) stand-in: an empty tensor on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def params_shape(cfg: ArchConfig) -> dict:
    """The parameter tree (``models.param_layout``) as meta tensors in
    ``cfg.param_dtype``."""
    dtype = getattr(torch, cfg.param_dtype)
    return tu.tree_map(lambda leaf: sds(leaf.shape, dtype),
                       param_layout(cfg))


def _enc(cfg: ArchConfig, batch: int):
    """(name, stand-in) of the vlm patches / audio frames, or None."""
    if cfg.family == "vlm":
        return sds((batch, cfg.num_patches, cfg.d_model), ACT_DTYPE)
    if cfg.family == "audio":
        return sds((batch, cfg.encoder_seq, cfg.d_model), ACT_DTYPE)
    return None


def train_batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((B, S), torch.int32),
             "labels": sds((B, S), torch.int32)}
    enc = _enc(cfg, B)
    if enc is not None:
        batch["enc_embeds"] = enc
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    return train_batch_specs(cfg, shape)


def decode_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """serve_step operands: a cache of seq_len, one new token, positions
    (and ``enc_out`` for the vlm and audio families)."""
    B, S = shape.global_batch, shape.seq_len
    out = {"cache": init_cache(cfg, B, S, device="meta"),
           "token": sds((B, 1), torch.int32),
           "pos": sds((B,), torch.int32)}
    enc = _enc(cfg, B)
    if enc is not None:
        out["enc_out"] = enc
    return out


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    if shape.kind == "decode":
        return decode_specs(cfg, shape)
    return train_batch_specs(cfg, shape)


def long_context_eligible(cfg: ArchConfig) -> bool:
    """long_500k runs only for sub-quadratic architectures: SSM / hybrid /
    sliding-window. Pure full-attention architectures are skipped."""
    return all(k in ("swa", "rglru", "rwkv") for k in cfg.layer_pattern)
