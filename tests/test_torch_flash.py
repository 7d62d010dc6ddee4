"""The port's flash-attention module against the JAX package's.

Same numpy inputs on both sides. The Pallas kernel runs in interpret mode
(``interpret=True``); on the CPU the port's wrapper takes the kernel's
plain version, which is what is held here (the CUDA kernel is held
against that plain version on the card, ``chip_smoke.py``).

Tolerance: the one the CUDA kernel is held to against the plain version,
``tolerance`` of the port's module: fp32 atol 2e-5 and rtol 2e-3, as in
``tests/test_flash_kernel.py``; bf16 2^-6 (|ref| + rms of ref's row over
hd) (the Pallas kernel keeps the probabilities in fp32, the block scan
rounds them to bf16 before P V).
The port's ``chunked_attention`` repeats the reference's block scan
operation for operation: fp32 within 1e-6, bf16 within one bf16 ulp
(2^-8) of the largest output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as TL
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _assert_close(got, want, dtype):
    ref = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(
        DTYPES[dtype][1])
    assert got.dtype == ref.dtype
    assert bool(((got.float() - ref.float()).abs()
                 <= tfa.tolerance(ref)).all())


def _qkv(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, hd)).astype(np.float32))


# the five shape / block / mask cases of tests/test_flash_kernel.py
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S,H,hd,bq,bk,causal,window", [
    (128, 2, 64, 64, 64, True, None),
    (128, 2, 64, 128, 32, True, None),
    (256, 1, 128, 64, 128, True, None),
    (128, 2, 64, 64, 64, False, None),
    (256, 2, 64, 64, 64, True, 96),
])
def test_plain_matches_pallas_kernel(S, H, hd, bq, bk, causal, window,
                                     dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(S + hd, 2, S, H, H, hd)
    want = pallas_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                        causal=causal, window=window, block_q=bq,
                        block_k=bk, interpret=True)
    tfa.reset_launches()
    got = tfa.flash_attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)),
                              causal=causal, window=window)
    assert got.dtype == tdt and tfa.LAUNCHES["flash_attention"] == 0
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gqa_matches_pre_expanded_pallas_call(dtype):
    """Hkv < H: the port indexes the KV group; the reference expands the
    heads before its call."""
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(5, 2, 128, 4, 2, 64)
    kx, vx = (np.repeat(t, 2, axis=2) for t in (k, v))
    want = pallas_flash(*(jnp.asarray(x, jdt) for x in (q, kx, vx)),
                        block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)))
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_chunked_attention_matches_reference(causal, window, dtype):
    """Explicit positions with -1 (empty) key slots, GQA, a ragged last
    block (block_k 32 over 100 keys)."""
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(11, 2, 100, 4, 2, 64)
    pos = np.broadcast_to(np.arange(100, dtype=np.int32), (2, 100)).copy()
    kv_pos = pos.copy()
    kv_pos[1, 90:] = -1
    want = JL.chunked_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(kv_pos),
        causal=causal, window=window, block_k=32)
    got = TL.chunked_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        q_positions=torch.from_numpy(pos).long(),
        kv_positions=torch.from_numpy(kv_pos).long(), causal=causal,
        window=window, block_k=32)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    else:
        # exp differs in the last fp32 ulp, which can move a
        # probability's bf16 rounding: one bf16 ulp of the largest output
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2.0 ** -8 * np.abs(want).max(),
                                   rtol=2.0 ** -8)


def test_ragged_length_matches_a_padded_reference():
    """Any S: 100 rows against the reference scan over the same rows."""
    q, k, v = _qkv(3, 1, 100, 2, 2, 64)
    pos = np.broadcast_to(np.arange(100, dtype=np.int32), (1, 100))
    want = JL.chunked_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                q_positions=jnp.asarray(pos),
                                kv_positions=jnp.asarray(pos), window=30)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              window=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-3)


@pytest.mark.parametrize("bad,match", [
    (dict(k=(2, 64, 3, 64)), "split"),
    (dict(k=(2, 32, 2, 64)), "must be"),
    (dict(hd=40), "multiple of 16"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(window=0), "window"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    hd = bad.get("hd", 64)
    dt = bad.get("dtype", torch.float32)
    q = torch.zeros(2, 64, 4, hd, dtype=dt)
    k = torch.zeros(bad.get("k", (2, 64, 2, hd)), dtype=dt)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, k.clone(), window=bad.get("window"))


def test_wrapper_raises_on_other_devices():
    q = torch.zeros(1, 16, 2, 64, device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tfa.flash_attention(q, q, q)
