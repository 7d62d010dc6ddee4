"""Flash attention: the CUDA kernel's wrappers, its plain PyTorch version,
and the differentiable entry of the training path.

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

The training path differentiates through ``flash_attention_diff``, a
``torch.autograd.Function`` (counterpart of the reference's
``jax.custom_vjp`` ``_flash_attention``, ``repro/models/layers.py:134``):
its forward is the kernel on the card, which also writes each row's
log-sum-exp, or the plain scan with its (m, l) statistics on the CPU; its
backward is ``attention_scan_bwd``, the reference's ``_flash_bwd`` in plain
PyTorch (no Pallas kernel to port), which recomputes each key block's
probabilities from those statistics, and runs without recording a graph
(``torch.func.grad`` asks for one, for second derivatives that nothing
takes: it would keep each key block's probabilities to the end of the
pass). Its ``vmap`` rule folds a vmapped (chain) axis into the batch,
because a ctypes launch cannot read functorch's wrapped tensors.

Both CUDA entries are ``torch.library`` custom ops,
``repro_torch::flash_attention`` and ``repro_torch::flash_attention_lse``,
with a shape function for fake tensors, a FLOP formula for
``torch.utils.flop_counter`` and the op counter of
``roofline.hlo_analysis`` (the work the kernel does: causal tiles and
keys out of the window skipped), and a DTensor sharding rule
(``register_dtensor_rules``: batch or heads sharded, or replicated). A
wrapper calls the op on CUDA tensors and on fake ones (a dry run's, any
device), the plain version on real CPU tensors. ``_Attention`` stays the
outer layer, so ``torch.func`` transforms never see the op batched.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

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

def _mask(pos, qpos, causal, window):
    """Unmasked (query, key) pairs of a key block: pos (B, 1, 1, bk) key
    positions, -1 for empty slots; qpos (B, 1, Sq, 1)."""
    valid = pos >= 0
    if causal:
        valid = valid & (pos <= qpos)
    if window is not None:
        valid = valid & (pos > qpos - window)
    return valid


def attention_scan(q, k, v, q_positions, kv_positions, *, causal=True,
                   window: Optional[int] = None, block_k: int = BLOCK_K,
                   stats: bool = False):
    """The forward of the reference's ``_flash_fwd_scan``
    (``repro/models/layers.py:96``) with explicit positions: a scan over
    key blocks with running max and normaliser, so no (Sq x Sk) matrix
    is materialised. Scores in fp32 from exact products of the inputs;
    probabilities rounded to v's dtype before the P V product, as the
    reference does. q (B, Sq, H, hd), k/v (B, Sk, K, hd), positions
    (B, Sq) / (B, Sk) with -1 marking empty key slots. Returns
    (B, Sq, H, hd) in q's dtype, and with ``stats`` also each row's
    running max m and normaliser l, fp32 (B, H, Sq)."""
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
        s = torch.where(_mask(pos, qpos, causal, window), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqc,bchd->bhqd", p.to(v.dtype).to(f32), vh.to(f32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.transpose(1, 2).to(q.dtype)
    return (out, m, l) if stats else out


def attention_scan_bwd(q, k, v, q_positions, kv_positions, m, l, dout, *,
                       causal=True, window: Optional[int] = None,
                       block_k: int = BLOCK_K):
    """The reference's attention backward ``_flash_bwd``
    (``repro/models/layers.py:145``) in plain PyTorch: a scan over key
    blocks that recomputes each block's probabilities
    ``p = exp(s - m) / l`` from the forward's row statistics (B, H, Sq)
    (the kernel's log-sum-exp is m with l = 1), ``ds = p (dp - D) scale``
    with ``dp = dout v^T``, and the expanded heads' dk, dv summed back
    onto their Hkv KV heads; everything in fp32, each gradient returned in
    its input's dtype. The probabilities are used as p / Z, Z their row
    sum, so that they sum to 1 whatever the statistics' rounding (the
    kernel's log-sum-exp comes from approximate exp2/log2): a query that
    sees one key gets p = 1 and its exact zero gradient. ``D =
    rowsum(dout * out)`` is taken as ``rowsum(p * dp)``, its value at the
    fp32 output (as the reference holds it): the output the caller holds
    is rounded to its dtype (bf16), and ``dp - D`` cancels, so the rounded
    output would move dk by more than a bf16 ulp (the output is therefore
    not a residual).
    With one key block (S <= block_k, the sampling path) that block is
    computed once; with more, the blocks are recomputed for Z, for D and
    for the gradients. Out of place throughout, so that it runs under
    ``torch.func.vmap``."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    f32 = torch.float32
    qf = q.to(f32)
    do = dout.transpose(1, 2).to(f32)                  # (B, H, Sq, hd)
    linv = 1.0 / torch.clamp_min(l, 1e-30)
    qpos = q_positions[:, None, :, None]

    def block(s0):
        kh = k[:, s0:s0 + block_k].repeat_interleave(G, dim=2).to(f32)
        vh = v[:, s0:s0 + block_k].repeat_interleave(G, dim=2).to(f32)
        pos = kv_positions[:, None, None, s0:s0 + block_k]
        s = torch.einsum("bqhd,bchd->bhqc", qf, kh) * scale
        p = torch.where(_mask(pos, qpos, causal, window),
                        torch.exp(s - m[..., None]), 0.0) * linv[..., None]
        return kh, p, torch.einsum("bhqd,bchd->bhqc", do, vh)

    starts = range(0, Sk, block_k)
    one = [block(0)] if len(starts) == 1 else None

    def blocks():
        return one if one is not None else map(block, starts)

    Z = torch.clamp_min(sum(p.sum(-1) for _, p, _ in blocks()), 1e-30)
    D = sum(((p / Z[..., None]) * dp).sum(-1) for _, p, dp in blocks())
    dq = torch.zeros((B, Sq, H, hd), dtype=f32, device=q.device)
    dks, dvs = [], []
    for kh, p, dp in blocks():
        p = p / Z[..., None]
        ds = p * (dp - D[..., None]) * scale
        dq = dq + torch.einsum("bhqc,bchd->bqhd", ds, kh)
        dkh = torch.einsum("bhqc,bqhd->bchd", ds, qf)
        dvh = torch.einsum("bhqc,bhqd->bchd", p, do)
        bk = kh.shape[1]
        dks.append(dkh.reshape(B, bk, K, G, hd).sum(3))
        dvs.append(dvh.reshape(B, bk, K, G, hd).sum(3))
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


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


def _launch(q, k, v, causal, window, lse):
    """One launch of the kernel on CUDA tensors; ``lse`` (B, H, S) fp32
    or None (the serving entry: the kernel writes no statistics)."""
    dev = q.device
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
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(out))
    rest = (B, S, H, k.shape[2], hd, int(causal),
            0 if window is None else int(window))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if lse is None:
            err = lib.flash_attention_launch(DTYPES.index(q.dtype), *args,
                                             *rest, stream)
        else:
            err = lib.flash_attention_lse_launch(
                DTYPES.index(q.dtype), *args, _ptr(lse), *rest, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: cudaError {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    LAUNCHES["flash_attention"] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int) -> torch.Tensor:
    return _launch(q, k, v, causal, window or None, None)


@_flash_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=(),
                         device_types="cuda")
def _flash_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window or None, lse), lse


@_flash_lse_op.register_fake
def _(q, k, v, causal, window):
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, S), dtype=torch.float32)


@functools.lru_cache(maxsize=256)
def _tiles(S: int, bq: int, bk: int, causal: bool, window: int) -> int:
    """(query block, key tile) pairs the kernel computes for one (batch,
    head), as its ``key_range`` walks them: query rows [q0, q0 + bq),
    keys from the tile of max(0, q0 - window + 1) to the tile holding
    min(S, q0 + bq) - 1 (causal) or S - 1."""
    n = 0
    for q0 in range(0, S, bq):
        kend = min(S, q0 + bq) if causal else S
        kbeg = max(0, q0 - window + 1) if window > 0 else 0
        n += -(-kend // bk) - kbeg // bk
    return n


def flops(q_shape, dtype, causal: bool, window: Optional[int]) -> int:
    """FLOPs of one launch, the work the kernel does: the QK^T and PV
    products (2 x 2 hd per score) of every (query block, key tile) it
    visits, full tiles where they meet the diagonal or the window's edge,
    tiles wholly masked skipped. bf16: 128 query rows by 128 keys (64
    above hd 128); fp32: 8 rows by 32 keys."""
    B, S, H, hd = (int(d) for d in q_shape)
    if dtype == torch.bfloat16:
        bq, bk = 128, (128 if hd <= 128 else 64)
    else:
        bq, bk = 8, 32
    return 4 * B * H * hd * bq * bk * _tiles(S, bq, bk, bool(causal),
                                             int(window or 0))


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_lse],
                       get_raw=True)
def _flash_flops(q, k, v, causal, window, *args, **kwargs) -> int:
    return flops(q.shape, q.dtype, causal, window)


def register_dtensor_rules() -> None:
    """DTensor sharding rules of the two ops (once per process): q, k, v
    and the output sharded alike over the batch or the heads (a head
    shard keeps its KV-head groups whole when both head counts divide),
    or everything replicated; the log-sum-exp (B, H, S) follows."""
    if _RULES_DONE:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def rules(with_lse):
        def fn(q, k, v, causal, window):
            out = []
            for qd, ld in ((None, None), (0, 0), (2, 1)):
                pq = Replicate() if qd is None else Shard(qd)
                outs = [pq] + ([Replicate() if ld is None else Shard(ld)]
                               if with_lse else [])
                out.append((outs, [pq, pq, pq, None, None]))
            return out
        return fn

    register_sharding(torch.ops.repro_torch.flash_attention.default)(
        rules(False))
    register_sharding(torch.ops.repro_torch.flash_attention_lse.default)(
        rules(True))
    _RULES_DONE.append(True)


_RULES_DONE: list = []


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, Hkv, hd), fp32 or bf16, H % Hkv == 0,
    hd a multiple of 16 up to 256, any S. Returns (B, S, H, hd) in q's
    dtype. Real CPU tensors take the plain version; CUDA tensors launch
    the kernel on PyTorch's current stream (through the custom op, which
    also answers fake tensors)."""
    _check(q, k, v, window)
    if q.device.type == "cpu" and not is_fake(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" and not is_fake(q):
        raise RuntimeError(f"flash_attention runs on cuda or cpu tensors, "
                           f"not {q.device.type}")
    return _flash_op(q, k, v, causal, window or 0)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None):
    """``flash_attention`` and each row's log-sum-exp of its masked scaled
    scores, fp32 (B, H, S): one launch of the kernel's statistics entry on
    CUDA tensors; on CPU tensors the plain scan, with m + log(l)."""
    _check(q, k, v, window)
    if q.device.type == "cpu" and not is_fake(q):
        out, m, l = _plain_stats(q, k, v, None, None, causal, window,
                                 BLOCK_K)
        return out, m + torch.log(torch.clamp_min(l, 1e-30))
    if q.device.type != "cuda" and not is_fake(q):
        raise RuntimeError(f"flash_attention runs on cuda or cpu tensors, "
                           f"not {q.device.type}")
    return _flash_lse_op(q, k, v, causal, window or 0)


# ---------------------------------------------------------------------------
# the differentiable entry
# ---------------------------------------------------------------------------

def _plain_stats(q, k, v, q_positions, kv_positions, causal, window,
                 block_k):
    if q_positions is None:
        B, S = q.shape[:2]
        q_positions = kv_positions = torch.arange(
            S, device=q.device).expand(B, S)
    return attention_scan(q, k, v, q_positions, kv_positions, causal=causal,
                          window=window, block_k=block_k, stats=True)


class _Shards:
    """The plain scans of DTensor operands (a pod mesh's) on each rank's
    own shards: q, k and v (B, S, H, hd) placed alike, sharding only the
    batch or the heads, as ``models.layers.attention_layout`` places
    them. Every product is independent per (row, head), so the scan runs
    on local tensors, as XLA runs the reference's, and its outputs are
    wrapped back. (DTensor would flatten the sharded batch and head dims
    into one in the scans' einsums, which torch 2.11's view rule
    refuses.) ``of`` is None for plain tensors and any other layout."""

    def __init__(self, q):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh, self.pl = q.device_mesh, list(q.placements)
        # positions (B, S) and row statistics (B, H, S) on the same shards
        self.rows = [p if p == Shard(0) else Replicate() for p in self.pl]
        self.stats = [Shard(1) if p == Shard(2) else p for p in self.pl]

    @staticmethod
    def of(q, k, v):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(q, DTensor):
            return None
        pl = list(q.placements)
        alike = all(isinstance(t, DTensor) and list(t.placements) == pl
                    for t in (k, v))
        if not alike or any(p not in (Shard(0), Shard(2), Replicate())
                            for p in pl):
            return None
        return _Shards(q)

    def local(self, t, pl):
        """t's local shard placed by ``pl`` (None stays None)."""
        from repro_torch.sharding.rules import local_shard
        return None if t is None else local_shard(t, self.mesh, pl)

    def wrap(self, t, pl):
        """Local t wrapped as a DTensor placed by ``pl`` (even shards)."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, pl, run_check=False)


class _Attention(torch.autograd.Function):
    """(out, m, l) of attention with the reference's flash backward.
    Positions None: implicit (row = position), and on CUDA tensors the
    forward is one launch of the kernel, whose log-sum-exp stands in for
    (m, l = 1). Positions given: the plain scan on any device. DTensor
    operands run the plain scans on their local shards (``_Shards``)."""

    @staticmethod
    def forward(q, k, v, q_positions, kv_positions, causal, window,
                block_k):
        if q_positions is None and (q.device.type == "cuda"
                                    or is_fake(q)):
            out, lse = flash_attention_lse(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=causal,
                                           window=window)
            return out, lse, torch.ones_like(lse)
        sh = _Shards.of(q, k, v)
        if sh is None:
            return _plain_stats(q, k, v, q_positions, kv_positions, causal,
                                window, block_k)
        out, m, l = _plain_stats(
            *(sh.local(t, sh.pl) for t in (q, k, v)),
            *(sh.local(t, sh.rows) for t in (q_positions, kv_positions)),
            causal, window, block_k)
        return (sh.wrap(out, sh.pl), sh.wrap(m, sh.stats),
                sh.wrap(l, sh.stats))

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, q_positions, kv_positions, causal, window, block_k = inputs
        _, m, l = output
        ctx.mark_non_differentiable(m, l)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, m, l)
        ctx.causal, ctx.window, ctx.block_k = causal, window, block_k

    @staticmethod
    def backward(ctx, dout, _dm, _dl):
        q, k, v, q_positions, kv_positions, m, l = ctx.saved_tensors
        sh = _Shards.of(q, k, v)
        if sh is not None:
            q, k, v, dout = (sh.local(t, sh.pl) for t in (q, k, v, dout))
            q_positions, kv_positions = (
                sh.local(t, sh.rows) for t in (q_positions, kv_positions))
            m, l = (sh.local(t, sh.stats) for t in (m, l))
        if q_positions is None:
            B, S = q.shape[:2]
            q_positions = kv_positions = torch.arange(
                S, device=q.device).expand(B, S)
        # torch.func.grad differentiates with create_graph=True: recorded,
        # this backward would keep every key block's fp32 probabilities
        # until the pass ends (~9 GB per layer at whisper's encoder shape,
        # B 4 x 1,500 frames) for a second derivative nobody takes
        with torch.no_grad():
            dq, dk, dv = attention_scan_bwd(
                q, k, v, q_positions, kv_positions, m, l, dout,
                causal=ctx.causal, window=ctx.window, block_k=ctx.block_k)
        if sh is not None:
            dq, dk, dv = (sh.wrap(t, sh.pl) for t in (dq, dk, dv))
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_positions, kv_positions, causal,
             window, block_k):
        """Fold the vmapped axis into the batch: (n, B, ...) -> (n*B, ...)
        for every tensor (an unbatched one is broadcast first), one call,
        then unfold the three outputs."""
        n = info.batch_size

        def fold(t, d):
            if t is None:
                return None
            t = t.movedim(d, 0) if d is not None \
                else t.expand((n,) + tuple(t.shape))
            return t.reshape((n * t.shape[1],) + tuple(t.shape[2:]))

        args = [fold(t, d) for t, d in zip(
            (q, k, v, q_positions, kv_positions), in_dims[:5])]
        outs = _Attention.apply(*args, causal, window, block_k)
        return tuple(o.reshape((n, -1) + tuple(o.shape[1:]))
                     for o in outs), (0, 0, 0)


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention`` with a gradient: the training path's attention
    (same contract and dtypes). On CUDA tensors the forward is one launch
    of the kernel (counted in ``LAUNCHES``) and the backward the plain
    ``attention_scan_bwd``; on CPU tensors both are plain. Composes with
    ``torch.func.grad`` and ``torch.func.vmap``."""
    _check(q, k, v, window)
    return _Attention.apply(q, k, v, None, None, causal, window, BLOCK_K)[0]


def scan_attention(q, k, v, q_positions, kv_positions, *, causal=True,
                   window: Optional[int] = None, block_k: int = BLOCK_K):
    """``attention_scan`` with explicit positions and the flash backward
    (the reference's ``chunked_attention``), plain on every device."""
    return _Attention.apply(q, k, v, q_positions, kv_positions, causal,
                            window, block_k)[0]
