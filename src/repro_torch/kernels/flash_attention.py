"""Forward flash attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``flash_attention``): ``softmax(q k^T * hd^-0.5, masked) v`` with a running
(m, l, acc) online softmax in fp32 over key blocks, causal and/or
sliding-window masks with ``NEG_INF = -1e30``, and ``acc / max(l, 1e-30)``
in the input dtype. Positions are implicit (row = absolute position).

Layout is the JAX package's: q ``(B, S, H, hd)``, k and v
``(B, S, Hkv, hd)`` with ``H % Hkv == 0``; query head h reads KV head
``h // (H // Hkv)`` (the reference expands the heads before its call; the
kernel indexes the group instead). Dispatch is by device: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel
(``csrc/flash_attention.cu``, built at first use by ``_build``) and any
other device raises. The plain version is the oracle the kernel is held
against on the card, never a fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)  # the kernel's dtype codes 0, 1
BLOCK_K = 512  # the reference's chunked_attention block

# Kernel launches: the wrapper adds one where it launches the CUDA kernel,
# and nowhere else (the plain version does not count).
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def attention_scan(q, k, v, q_positions, kv_positions, *, causal=True,
                   window: Optional[int] = None, block_k: int = BLOCK_K):
    """The forward of the reference's ``_flash_fwd_scan``
    (``repro/models/layers.py:96``) with explicit positions: a scan over
    key blocks with running max and normaliser, so no (Sq x Sk) matrix
    is materialised. Scores in fp32 from exact products of the inputs;
    probabilities rounded to v's dtype before the P V product, as the
    reference does. q (B, Sq, H, hd), k/v (B, Sk, K, hd), positions
    (B, Sq) / (B, Sk) with -1 marking empty key slots. Returns
    (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    f32 = torch.float32
    qf = q.to(f32)
    m = torch.full((B, H, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=f32, device=q.device)
    qpos = q_positions[:, None, :, None]
    for s0 in range(0, Sk, block_k):
        kh = k[:, s0:s0 + block_k].repeat_interleave(G, dim=2)
        vh = v[:, s0:s0 + block_k].repeat_interleave(G, dim=2)
        pos = kv_positions[:, None, None, s0:s0 + block_k]
        s = torch.einsum("bqhd,bchd->bhqc", qf, kh.to(f32)) * scale
        valid = pos >= 0
        if causal:
            valid = valid & (pos <= qpos)
        if window is not None:
            valid = valid & (pos > qpos - window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqc,bchd->bhqd", p.to(v.dtype).to(f32), vh.to(f32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def tolerance(ref: torch.Tensor) -> torch.Tensor:
    """The largest |kernel - plain| allowed at each element of ``ref``, a
    plain-version output in its own dtype. fp32: 2e-5 + 2e-3 |ref| (sums
    in another order). bf16: both round P to bf16 before P V, each
    against its own running max, so each term of an output may move by
    an ulp: noise of about 2^-9 of the row's scale at any length, then
    the output's own rounding, an ulp. Hence 2^-6 (|ref| + rms of ref's
    row over hd), which a few keys dropped or misweighted in the late
    rows of a long sequence exceed."""
    r = ref.float()
    if ref.dtype == torch.float32:
        return 2e-5 + 2e-3 * r.abs()
    return 2.0 ** -6 * (r.abs() + r.pow(2).mean(-1, True).sqrt())


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          block_k: int = BLOCK_K):
    """Plain version of the kernel (same contract): ``attention_scan``
    with implicit positions."""
    B, S = q.shape[:2]
    pos = torch.arange(S, device=q.device).expand(B, S)
    return attention_scan(q, k, v, pos, pos, causal=causal, window=window,
                           block_k=block_k)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be (B, S, heads, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, S, Hkv, hd) = ({B}, {S}, "
                         f"Hkv, {hd}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not split into {k.shape[2]} "
                         "KV-head groups")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"head_dim {hd} must be a multiple of 16 in "
                         "[16, 256]")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, "
                         f"{v.device}")


def _ptr(t):
    if not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned (TMA "
                         "and the kernel's 16-byte vectors need it)")
    return ctypes.c_void_p(t.data_ptr())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, Hkv, hd), fp32 or bf16, H % Hkv == 0,
    hd a multiple of 16 up to 256, any S. Returns (B, S, H, hd) in q's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel on PyTorch's current stream."""
    _check(q, k, v, window)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise RuntimeError(f"flash_attention runs on cuda or cpu tensors, "
                           f"not {dev.type}")
    B, S, H, hd = q.shape
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid "
                         "(65,535)")
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            DTYPES.index(q.dtype), _ptr(q), _ptr(k), _ptr(v), _ptr(out), B,
            S, H, k.shape[2], hd, int(causal),
            0 if window is None else int(window), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: cudaError {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    LAUNCHES["flash_attention"] += 1
    return out
