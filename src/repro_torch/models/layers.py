"""Layer primitives of the dense attention transformer (counterpart of
``repro.models.layers``).

Tensors keep the JAX package's layouts: activations (B, S, D), attention
(B, S, heads, hd), caches (B, S_cache, K, hd). Two attention modes:

* ``chunked_attention`` — full sequence (training, prefill), the plain
  block scan with explicit positions and the reference's flash backward
  (``kernels.flash_attention.attention_scan_bwd``, the port of
  ``_flash_bwd``), so it differentiates like the reference's
  ``jax.custom_vjp``;
* ``decode_attention``  — one token against a (possibly ring) cache.

The MoE FFN, RG-LRU and RWKV-6 blocks are not ported yet (ROADMAP item 15).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import NEG_INF, scan_attention


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor,
                      kv_positions: torch.Tensor, causal: bool = True,
                      window: Optional[int] = None,
                      block_k: int = 512) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a scan over KV blocks with
    running max / normaliser (the reference's ``_flash_fwd_scan``), whose
    gradient is the reference's flash backward (residuals q, k, v, m,
    l; per-block probabilities recomputed). q (B, Sq, H, hd), k/v
    (B, Sk, K, hd) with H % K == 0 (KV heads expanded per block);
    positions (B, Sq) and (B, Sk), -1 marking empty key slots."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not split into "
                         f"{k.shape[2]} KV heads")
    return scan_attention(q, k, v, q_positions, kv_positions, causal=causal,
                          window=window, block_k=block_k)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     q_position: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffer) cache, in fp32.
    q (B, 1, H, hd); caches (B, S, K, hd); kv_positions (B, S) with -1
    for empty slots; q_position (B,)."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg,
                     k_cache.to(torch.float32)) * hd ** -0.5
    valid = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# feed-forward (dense)
# ---------------------------------------------------------------------------

def ffn_apply(x: torch.Tensor, p: dict, ffn_type: str) -> torch.Tensor:
    """Dense FFN; gelu is the tanh approximation, as ``jax.nn.gelu``."""
    if ffn_type == "silu":
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    elif ffn_type == "geglu":
        h = F.gelu(x @ p["wi_gate"], approximate="tanh") * (x @ p["wi_up"])
    elif ffn_type == "gelu":
        h = F.gelu(x @ p["wi_up"], approximate="tanh")
    else:
        raise ValueError(f"unknown ffn_type {ffn_type!r}")
    return h @ p["wo"]
