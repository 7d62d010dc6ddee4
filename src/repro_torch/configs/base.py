"""Config dataclasses for architectures, input shapes and sampler
settings (counterpart of ``repro.configs.base``).

Every architecture has one ``<id>.py`` module in this package exposing
``CONFIG`` (the published configuration, cited) and ``smoke_config()``
(a reduced variant of the same family for CPU tests: <=2 layers,
d_model<=512, <=4 experts). The registry looks every one of them up; the
model refuses the layer kinds the port does not run yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Family = str  # 'dense' | 'moe' | 'vlm' | 'audio' | 'hybrid' | 'ssm'


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Transformer-family architecture description.

    ``layer_pattern`` is the repeating per-period layer recipe; the model
    stacks the parameters of all full periods along a leading axis. Entries:
      'attn'   full self attention (GQA per num_kv_heads)
      'swa'    sliding-window self attention (window = swa_window)
      'rglru'  RG-LRU recurrent block (Griffin)
      'rwkv'   RWKV6 time-mix block
      'xattn'  cross attention to encoder/frontend embeddings
    A dense decoder layer is ('attn',); recurrentgemma is
    ('rglru','rglru','swa'); the VLM is ('attn',)*4 + ('xattn',).
    """

    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int
    source: str  # citation: hf model card or arXiv id

    ffn_type: str = "silu"  # 'silu' (SwiGLU) | 'geglu' | 'gelu'
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    layer_pattern: Tuple[str, ...] = ("attn",)
    swa_window: int = 4096
    moe: Optional[MoEConfig] = None

    # encoder-decoder (audio): number of encoder layers; decoder uses
    # num_layers. Encoder input is a stubbed frame-embedding sequence.
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 30 s of audio -> 1500 frames
    # vlm: number of stubbed image patch embeddings cross-attended to.
    num_patches: int = 0

    # sampler-facing knobs
    param_dtype: str = "float32"
    surrogate_dtype: str = "bfloat16"
    remat: bool = True

    def __post_init__(self):
        if self.family not in ("dense", "moe", "vlm", "audio", "hybrid",
                               "ssm"):
            raise ValueError(f"unknown family {self.family!r}")
        for kind in self.layer_pattern:
            if kind not in ("attn", "swa", "rglru", "rwkv", "xattn"):
                raise ValueError(f"unknown layer kind {kind!r}")
        if self.family == "moe" and self.moe is None:
            raise ValueError("family 'moe' needs a MoEConfig")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer does full self attention over the sequence."""
        return all(k != "attn" for k in self.layer_pattern)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d
        head = v * d  # untied output head
        n = 0
        per = {}
        per["attn"] = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        per["swa"] = per["attn"]
        per["xattn"] = per["attn"]
        per["rglru"] = 4 * d * d  # in/out projections + gates (approx.)
        per["rwkv"] = 4 * d * d + 6 * d  # r,k,v,o + decay/mix vectors (approx.)
        if self.ffn_type in ("silu", "geglu"):
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        if self.moe is not None:
            ffn = self.moe.num_experts * ffn + d * self.moe.num_experts
        pat = self.layer_pattern
        for i in range(self.num_layers):
            n += per[pat[i % len(pat)]] + ffn + 2 * d  # + norms
        if self.encoder_layers:
            enc_ffn = 3 * d * f if self.ffn_type in ("silu", "geglu") else 2 * d * f
            n += self.encoder_layers * (per["attn"] + enc_ffn + 2 * d)
            # decoder cross-attn to encoder happens via 'xattn' entries
        return emb + head + n

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        dense_like = dataclasses.replace(self, family="dense", moe=None)
        d, f = self.d_model, self.d_ff
        ffn = 3 * d * f if self.ffn_type in ("silu", "geglu") else 2 * d * f
        extra = self.num_layers * ffn * (self.moe.top_k - 1)
        return dense_like.param_count() + extra


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# Above this client count an implicit uniform ``probs()`` tuple is not
# materialized; ``probs()`` returns None and consumers treat None as
# uniform 1/S (``core.sampler.ShardScheme`` lowers both spellings to the
# same fp32 values).
_PROBS_TUPLE_LIMIT = 65536


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """FSGLD / DSGLD / SGLD settings (paper Secs. 2-3)."""

    method: str = "fsgld"  # 'sgld' | 'dsgld' | 'fsgld'
    step_size: float = 1e-4
    num_shards: int = 16
    shard_probs: Optional[Tuple[float, ...]] = None  # None -> uniform
    local_updates: int = 40  # T_local between reassignments (paper Sec 5.3)
    alpha: float = 1.0  # Remark 1 exploration knob; 0 recovers DSGLD
    surrogate: str = "diag"  # 'diag' | 'scalar' | 'linear' | 'full'
    prior_precision: float = 1.0  # N(0, lambda^-1 I) prior on params
    temperature: float = 1.0  # noise scale; 0 -> MAP/SGD limit

    def probs(self) -> Optional[Tuple[float, ...]]:
        if self.shard_probs is not None:
            if len(self.shard_probs) != self.num_shards:
                raise ValueError(
                    f"{len(self.shard_probs)} shard_probs for "
                    f"{self.num_shards} shards")
            return tuple(self.shard_probs)
        if self.num_shards > _PROBS_TUPLE_LIMIT:
            return None
        return tuple(1.0 / self.num_shards for _ in range(self.num_shards))
