"""The port's MoE FFN, RG-LRU and RWKV-6 blocks against the JAX package.

Same numpy-made inputs and parameters on both sides, fp32 throughout:

* per block, value and ``torch.func.grad`` against ``jax.grad``:
  ``moe_ffn`` for the three FFN types with capacity drops (capacity
  factor 1.25) and without them, ``_moe_group`` (the reference's
  sort-based oracle) against the reference's and against
  ``_moe_dense_dispatch``; ``rglru_forward`` with and without a carried
  h0; ``rwkv_forward`` over a ragged last chunk, with and without a
  carried state; and each decode stepped token by token against its
  forward;
* per model, ``prefill_with_cache`` then ``decode_step`` against the
  reference's, the recurrent caches leaf by leaf, for the smoke configs
  of phi3.5-moe, grok-1, recurrentgemma-2b and rwkv6-7b, both packages
  in fp32 activations.

Tolerances are 1e-5 of the largest magnitude (the same fp32 arithmetic in
another order; measured at most 2e-6 over these cases).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad
from test_torch_train import fp32_activations  # noqa: F401 (fixture)

import repro.models.model as JM
import repro_torch.models.model as TM
from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro_torch import tree as tu
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _both(tree):
    """numpy tree -> (JAX tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            tu.tree_map(torch.from_numpy, tree))


def _weights(rng, shapes):
    """N(0, 1/fan_in) fp32 weights; fan_in is the second-to-last axis."""
    return {n: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
            for n, s in shapes.items()}


def _grads_close(gt, gj):
    for a, b in zip(tu.leaves(gt), jax.tree.leaves(gj)):
        _close(a, b)


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

D, F_, E, K = 32, 48, 4, 2


def _moe_params(rng, ffn_type):
    shapes = {"router": (D, E), "experts_wo": (E, F_, D),
              "experts_wi_up": (E, D, F_)}
    if ffn_type != "gelu":
        shapes["experts_wi_gate"] = (E, D, F_)
    return _weights(rng, shapes)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("ffn_type", ["silu", "geglu", "gelu"])
def test_moe_ffn_matches_jax(ffn_type, capacity_factor):
    """(2, 64, 32) tokens in one group of 64, 4 experts, top-2: the output,
    the aux loss and the gradient of sum(y * w) + 3 aux in x and every
    parameter. Tokens share a component, so the routing is skewed; at
    capacity factor 1.25 (capacity 40 of 128 routes) some routes are
    dropped: the output differs from the drop-free one."""
    rng = np.random.default_rng(1)
    pj, pt = _both(_moe_params(rng, ffn_type))
    # a component shared by every token skews the routing
    x = (rng.standard_normal((2, 64, D)) + 2 * rng.standard_normal(D)
         ).astype(np.float32)
    w = rng.standard_normal((2, 64, D)).astype(np.float32)
    kw = dict(top_k=K, ffn_type=ffn_type, capacity_factor=capacity_factor)

    def loss_j(x, p):
        y, aux = JL.moe_ffn(x, p, **kw)
        return (y * w).sum() + 3.0 * aux

    def loss_t(x, p):
        y, aux = TL.moe_ffn(x, p, **kw)
        return (y * torch.from_numpy(w)).sum() + 3.0 * aux

    yj, auxj = jax.jit(lambda x, p: JL.moe_ffn(x, p, **kw))(jnp.asarray(x),
                                                           pj)
    yt, auxt = TL.moe_ffn(torch.from_numpy(x), pt, **kw)
    _close(yt, yj)
    assert abs(float(auxt) / float(auxj) - 1) < TOL
    if capacity_factor < 2:
        free, _ = TL.moe_ffn(torch.from_numpy(x), pt, **{
            **kw, "capacity_factor": 8.0})
        assert not torch.allclose(free, yt)
    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(x), pj)
    gt = grad(loss_t, argnums=(0, 1))(torch.from_numpy(x), pt)
    _grads_close(gt, gj)


def test_moe_group_is_the_dense_dispatch_oracle():
    """The port's sort-based ``_moe_group`` against the reference's (value,
    aux and gradients, capacity factor 1.25), and against the port's
    ``_moe_dense_dispatch`` where the capacity drops nothing (measured:
    equal)."""
    rng = np.random.default_rng(2)
    pj, pt = _both(_moe_params(rng, "silu"))
    x = rng.standard_normal((64, D)).astype(np.float32)
    kw = dict(top_k=K, ffn_type="silu", capacity_factor=1.25)
    yj, auxj = jax.jit(lambda x, p: JL._moe_group(x, p, **kw))(
        jnp.asarray(x), pj)
    yt, auxt = TL._moe_group(torch.from_numpy(x), pt, **kw)
    _close(yt, yj)
    assert abs(float(auxt) / float(auxj) - 1) < TOL
    gj = jax.jit(jax.grad(lambda x, p: (JL._moe_group(x, p, **kw)[0] ** 2)
                          .sum(), argnums=(0, 1)))(jnp.asarray(x), pj)
    gt = grad(lambda x, p: (TL._moe_group(x, p, **kw)[0] ** 2).sum(),
              argnums=(0, 1))(torch.from_numpy(x), pt)
    _grads_close(gt, gj)
    big = {**kw, "capacity_factor": 8.0}
    yg, auxg = TL._moe_group(torch.from_numpy(x), pt, **big)
    yd, auxd = TL._moe_dense_dispatch(torch.from_numpy(x)[None], pt, **big)
    _close(yd[0], yg.numpy(), 1e-6)
    assert abs(float(auxd) / float(auxg) - 1) < 1e-6


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_params(rng, d):
    p = _weights(rng, {n: (d, d) for n in
                       ("w_x", "w_gate", "w_out", "w_rec", "w_inp")})
    p["conv_w"] = (rng.standard_normal((4, d)) / 2).astype(np.float32)
    p["lam"] = (0.5 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    return p


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_forward_matches_jax(carried):
    """(2, 37, 16): y and h_last, and the gradient of sum(y^2) + sum(h_last)
    in x, the parameters (and h0). The carried h0 changes the first
    outputs."""
    rng = np.random.default_rng(3)
    pj, pt = _both(_rglru_params(rng, 16))
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32)
    args_j = (jnp.asarray(x), pj) + ((jnp.asarray(h0),) if carried else ())
    args_t = (torch.from_numpy(x), pt) + ((torch.from_numpy(h0),)
                                          if carried else ())

    def loss(fn):
        def f(*a):
            y, h = fn(*a)
            return (y ** 2).sum() + h.sum()
        return f

    yj, hj = jax.jit(JL.rglru_forward)(*args_j)
    yt, ht = TL.rglru_forward(*args_t)
    _close(yt, yj)
    _close(ht, hj)
    if carried:
        y_free, _ = TL.rglru_forward(*args_t[:2])
        assert not torch.allclose(y_free[:, 0], yt[:, 0])
    argnums = tuple(range(len(args_t)))
    gj = jax.jit(jax.grad(loss(JL.rglru_forward), argnums=argnums))(*args_j)
    gt = grad(loss(TL.rglru_forward), argnums=argnums)(*args_t)
    _grads_close(gt, gj)


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + b_t token by token,
    at a length that is not a power of two, with decays as strong as
    RG-LRU's (a ~ e^-8)."""
    g = torch.Generator().manual_seed(4)
    a = torch.exp(-8 * torch.rand((2, 45, 5), generator=g))
    b = torch.randn((2, 45, 5), generator=g)
    h, want = torch.zeros(2, 5), []
    for t in range(45):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(TL.linear_scan(a, b), torch.stack(want, 1),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_decode_steps_the_forward(carried):
    """Decode from {h0 (or 0), zero conv history} token by token: every
    output and the final h equal the forward's, and the conv history is
    the last 3 inputs of the conv (x @ w_x)."""
    rng = np.random.default_rng(5)
    _, p = _both(_rglru_params(rng, 16))
    x = torch.from_numpy(rng.standard_normal((2, 19, 16)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    state = TL.rglru_init_state(2, 16, TL.RGLRU_CONV, torch.float32)
    if carried:
        state["h"] = h0
    ys = []
    for t in range(19):
        y, state = TL.rglru_decode(x[:, t:t + 1], p, state)
        ys.append(y)
    yf, hf = TL.rglru_forward(x, p, h0 if carried else None)
    _close(torch.cat(ys, 1), yf.numpy())
    _close(state["h"], hf.numpy())
    _close(state["conv"], (x[:, -3:] @ p["w_x"]).numpy())


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

B_, S_, DM, H, HD, CHUNK = 2, 40, 32, 2, 16, 16


def _rwkv_params(rng):
    p = _weights(rng, {"w_r": (DM, H * HD), "w_k": (DM, H * HD),
                       "w_v": (DM, H * HD), "w_o": (H * HD, DM),
                       "w_lora_a": (DM, 64), "w_lora_b": (64, DM)})
    for n in "rkvw":
        p[f"mu_{n}"] = (0.5 + 0.2 * rng.standard_normal(DM)).astype(
            np.float32)
    p["w0"] = (-1 + 0.5 * rng.standard_normal(DM)).astype(np.float32)
    p["u"] = (0.3 * rng.standard_normal((H, HD))).astype(np.float32)
    return p


def _rwkv_state(rng):
    return {"S": rng.standard_normal((B_, H, HD, HD)).astype(np.float32),
            "x_prev": rng.standard_normal((B_, DM)).astype(np.float32)}


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_forward_matches_jax(carried):
    """(2, 40, 32), 2 heads of 16, chunks of 16 (the last one ragged): y
    and the final state, and the gradient of sum(y^2) + sum(S) in x, the
    parameters (and the carried state)."""
    rng = np.random.default_rng(6)
    pj, pt = _both(_rwkv_params(rng))
    sj, st = _both(_rwkv_state(rng))
    x = rng.standard_normal((B_, S_, DM)).astype(np.float32)
    args_j = (jnp.asarray(x), pj) + ((sj,) if carried else ())
    args_t = (torch.from_numpy(x), pt) + ((st,) if carried else ())

    def loss(fn):
        def f(*a):
            y, s = fn(*a, chunk=CHUNK)
            return (y ** 2).sum() + s["S"].sum()
        return f

    yj, outj = jax.jit(lambda *a: JL.rwkv_forward(*a, chunk=CHUNK))(*args_j)
    yt, outt = TL.rwkv_forward(*args_t, chunk=CHUNK)
    _close(yt, yj)
    for n in ("S", "x_prev"):
        _close(outt[n], outj[n])
    argnums = tuple(range(len(args_t)))
    gj = jax.jit(jax.grad(loss(JL.rwkv_forward), argnums=argnums))(*args_j)
    gt = grad(loss(TL.rwkv_forward), argnums=argnums)(*args_t)
    _grads_close(gt, gj)


def test_rwkv_backward_saves_no_pairwise_decays():
    """The chunks' (B, H, C, C, hd) pairwise decays are recomputed in the
    backward, as the reference's ``jax.checkpoint`` of its chunk body
    does: no tensor autograd saves for ``rwkv_forward`` is that large
    (autograd alone would save two per chunk)."""
    rng = np.random.default_rng(8)
    p = {n: torch.from_numpy(v).requires_grad_()
         for n, v in _rwkv_params(rng).items()}
    x = torch.from_numpy(rng.standard_normal((B_, S_, DM)).astype(
        np.float32)).requires_grad_()
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = TL.rwkv_forward(x, p, chunk=CHUNK)
    assert saved and max(saved) < B_ * H * CHUNK * CHUNK * HD
    y.square().sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in [x, *p.values()])


def test_rwkv_grad_under_vmap_matches_per_chain():
    """``torch.func.vmap`` of the gradient over two parameter sets (the
    engine's chain axis) equals each set's own gradient: the scores'
    backward composes with the transforms."""
    rng = np.random.default_rng(9)
    ps = [_both(_rwkv_params(rng))[1] for _ in range(2)]
    x = torch.from_numpy(rng.standard_normal((B_, S_, DM)).astype(
        np.float32))

    def loss(p):
        return TL.rwkv_forward(x, p, chunk=CHUNK)[0].square().sum()

    stacked = tu.tree_map(lambda *t: torch.stack(t), *ps)
    got = torch.func.vmap(grad(loss))(stacked)
    for c, p in enumerate(ps):
        want = grad(loss)(p)
        for n in want:
            _close(got[n][c], want[n].numpy())


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_decode_steps_the_forward(carried):
    """Decode token by token from the zero (or a carried) state: every
    output and the final state equal the chunked forward's."""
    rng = np.random.default_rng(7)
    _, p = _both(_rwkv_params(rng))
    _, st = _both(_rwkv_state(rng))
    x = torch.from_numpy(rng.standard_normal((B_, S_, DM)).astype(
        np.float32))
    state = dict(st) if carried else TL.rwkv_init_state(
        B_, H, HD, DM, torch.float32)
    ys = []
    for t in range(S_):
        y, state = TL.rwkv_decode(x[:, t:t + 1], p, state)
        ys.append(y)
    yf, sf = TL.rwkv_forward(x, p, st if carried else None, chunk=CHUNK)
    _close(torch.cat(ys, 1), yf.numpy())
    for n in ("S", "x_prev"):
        _close(state[n], sf[n].numpy())


# ---------------------------------------------------------------------------
# per model: prefill, the caches, decode
# ---------------------------------------------------------------------------

NEW_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b", "recurrentgemma-2b",
             "rwkv6-7b")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_matches_jax_fp32(arch, fp32_activations):
    """The smoke config, a (2, 70) prompt (recurrentgemma's 64-slot window
    ring wraps), 4 greedy steps of the JAX stream teacher-forced: the
    prefill logits and every cache leaf (k/v and positions, RG-LRU's h
    and conv history, RWKV's S and x_prev) after the prefill and after
    the decode, and each step's logits."""
    jcfg, tcfg = jax_smoke(arch), torch_smoke(arch)
    pj = JM.init_params(jcfg, jax.random.PRNGKey(0))
    pt = TM.serving_params(params_from_jax(jax.tree.map(np.asarray, pj),
                                           tcfg))
    B, S, G = 2, 70, 4
    prompt = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = jax.jit(lambda p, t: JM.prefill_with_cache(p, jcfg, t, S + G))(
        pj, jnp.asarray(prompt))
    step = jax.jit(lambda c, t, q: JM.decode_step(pj, jcfg, c, t, q))
    lt, ct = TM.prefill_with_cache(pt, tcfg, torch.from_numpy(prompt).long(),
                                   S + G)

    def same_cache():
        jl = jax.tree.leaves(cj)
        names = [n for n, _ in tu.leaves_with_names(ct)]
        assert len(jl) == len(names)
        for n, a, b in zip(names, tu.leaves(ct), jl):
            assert tuple(a.shape) == b.shape, n
            if a.dtype == torch.int32:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                assert a.dtype == torch.float32, n
                _close(a, b)

    _close(lt, lj)
    same_cache()
    tok = np.asarray(jnp.argmax(lj, -1))
    for t in range(S, S + G):
        lj, cj = step(cj, jnp.asarray(tok[:, None]),
                      jnp.full((B,), t, jnp.int32))
        lt, ct = TM.decode_step(pt, tcfg, ct,
                                torch.from_numpy(tok[:, None]).long(),
                                torch.full((B,), t))
        _close(lt, lj)
        tok = np.asarray(jnp.argmax(lj, -1))
    same_cache()


def test_stacked_recurrent_states_are_written_in_place():
    """rwkv6-7b's smoke config stacks its 2 layers into one period: a
    decode step writes each layer's state into the stacked cache (a
    dict of views of it), so the cache object passed in carries the new
    states."""
    cfg = torch_smoke("rwkv6-7b")
    p = TM.serving_params(TM.init_params(cfg,
                                         torch.Generator().manual_seed(0)))
    cache = TM.init_cache(cfg, 2, 8)
    assert cache["blocks"]["l0"]["S"].shape[0] == 2
    tok = torch.ones((2, 1), dtype=torch.long)
    _, out = TM.decode_step(p, cfg, cache, tok,
                            torch.zeros(2, dtype=torch.long))
    assert out is cache
    for i in range(2):
        assert bool(cache["blocks"]["l0"]["S"][i].abs().sum() > 0)
        assert bool(cache["blocks"]["l0"]["x_prev"][i].abs().sum() > 0)


def test_recurrent_and_moe_layouts_match_the_reference():
    """The layouts carry a JAX tree across leaf by leaf (names, nesting,
    shapes), and the port's constant leaves are the reference's."""
    for arch in NEW_ARCHS:
        jcfg, tcfg = jax_smoke(arch), torch_smoke(arch)
        pj = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
        params_from_jax(pj, tcfg)
        pt = TM.init_params(tcfg, torch.Generator().manual_seed(0))
        for (n, a), b in zip(tu.leaves_with_names(pt), jax.tree.leaves(pj)):
            if n.split("/")[-1] in ("lam", "w0", "u", "norm", "ffn_norm") \
                    or n.split("/")[-1].startswith("mu_"):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=n)


def test_only_cross_attention_and_the_encoder_are_refused():
    """whisper (encoder + 'xattn') and llama-3.2-vision ('xattn') still
    wait for ROADMAP item 15."""
    for arch in ("whisper-large-v3", "llama-3.2-vision-90b"):
        with pytest.raises(NotImplementedError, match="item 15"):
            TM.param_layout(torch_smoke(arch))
    cfg = dataclasses.replace(torch_smoke("qwen3-1.7b"), encoder_layers=1)
    with pytest.raises(NotImplementedError, match="encoder.*item 15"):
        TM.param_layout(cfg)
