"""Plain PyTorch oracle of the fused FSGLD update (counterpart of
``repro.kernels.ref``): the same counter hash and Box-Muller transform as
the kernel, so the noise stream is a function of (seed, element index).

torch has no uint32 arithmetic on the CPU, so the hash runs in int64 with
every value kept in [0, 2^32): each operation is followed by a mask, and
32 x 32-bit products are split into 16-bit halves of the constant so that
no intermediate leaves int64's range. The hash-to-uniform step stays in
float32, where ``k * 2^-24 + 2^-25`` rounds exactly as the kernel does.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit ``c``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def uniforms(seed: torch.Tensor, idx: torch.Tensor):
    """The two float32 uniforms (u1 in (0, 1], u2 in [0, 1)) of element
    ``idx`` under ``seed``; both int64 holding uint32 values."""
    seed = seed.to(torch.int64) & MASK32
    idx = idx.to(torch.int64) & MASK32
    h1 = mix((idx * 2 + 1 + _mul32(seed, 0x9E3779B9)) & MASK32)
    h2 = mix((idx * 2 + _mul32(seed, 0x85EBCA77)) & MASK32)
    u1 = (h1 >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    u2 = (h2 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u1, u2


def gaussian_noise(seed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Standard normal per element (float32): the kernel's float32
    Box-Muller, ``sqrtf(-2 logf(u1)) * cosf(2π u2)``, with ``log`` and
    ``cos`` evaluated in float64 and rounded once to float32 (correctly
    rounded float32 values), so the result does not depend on which
    vectorised float32 ``log`` a CPU thread runs."""
    f32, f64 = torch.float32, torch.float64
    u1, u2 = uniforms(seed, idx)
    r = torch.sqrt(-2.0 * torch.log(u1.to(f64)).to(f32))
    return r * torch.cos(((2.0 * math.pi) * u2).to(f64)).to(f32)


def fsgld_update_flat(theta, g, seed, *, h, scale, f_s, prior_prec, alpha,
                      temperature, mu_g=None, mu_s=None, lam_g=None,
                      lam_s=None):
    """Flat-vector oracle. lam_g/lam_s may be scalars ('scalar' structure)
    or vectors ('diag'); mu_* None means plain SGLD/DSGLD (alpha ignored).
    Hyperparameters are float32 like the JAX oracle's."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                    device=theta.device)
    theta = theta.to(torch.float32)
    g = g.to(torch.float32)
    drift = -f32(prior_prec) * theta + f32(scale) * g
    if mu_g is not None:
        cond = f32(lam_g) * (mu_g.to(torch.float32) - theta) \
            - (f32(lam_s) / f32(f_s)) * (mu_s.to(torch.float32) - theta)
        drift = drift + f32(alpha) * cond
    idx = torch.arange(theta.shape[0], device=theta.device)
    xi = gaussian_noise(torch.as_tensor(seed, device=theta.device), idx)
    h = f32(h)
    return theta + (h / 2) * drift + torch.sqrt(h * f32(temperature)) * xi
