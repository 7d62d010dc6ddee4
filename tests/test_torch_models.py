"""The port's MoE FFN, RG-LRU and RWKV-6 blocks, cross-attention and the
encoder against the JAX package.

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
  of phi3.5-moe, grok-1, recurrentgemma-2b, rwkv6-7b, llama-3.2-vision
  and whisper, both packages in fp32 activations;
* the vlm and audio families (llama-3.2-vision's gated cross-attention,
  whisper's encoder and cross-attention) at their smoke configs:
  ``encoder_forward``, ``forward`` and ``log_lik_fn`` with ``enc_embeds``
  and ``torch.func.grad`` of it against ``jax.grad``, in fp32
  activations, every vlm gate set to 0.5 in both trees (at init a gate
  is 0, and tanh(0) hides the cross-attention); the port's own forward
  against its token-by-token decode in bf16 (5e-2 of the largest logit,
  the reference's ``test_prefill_decode_parity``); the layouts against
  the reference's ``init_params`` at full width; ``make_batch``.

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
from _torch_train_common import fp32_activations  # noqa: F401 (fixture)

import repro.models.model as JM
import repro_torch.models.model as TM
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import InputShape as JShape
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import layers as JL
from repro_torch import api
from repro_torch import tree as tu
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.configs.base import InputShape as TShape
from repro_torch.convert import params_from_jax
from repro_torch.data import make_batch, token_shards
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

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

ENC_ARCHS = ("llama-3.2-vision-90b", "whisper-large-v3")
NEW_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b", "recurrentgemma-2b",
             "rwkv6-7b") + ENC_ARCHS


def _open_gates(tree, value=0.5):
    """Every vlm 'xattn' gate of a numpy parameter tree set to ``value``
    (in place; a tree without gates is left as it is)."""
    for group in ("blocks", "rem_blocks"):
        for layer in tree.get(group, {}).values():
            if "gate" in layer.get("xattn", {}):
                layer["xattn"]["gate"] = np.full_like(layer["xattn"]["gate"],
                                                      value)
    return tree


def _model_params(arch, seed=0):
    """(JAX config, port config, JAX params, port params) of ``arch``'s
    smoke config: the reference's init, its vlm gates opened to 0.5,
    carried across."""
    jcfg, tcfg = jax_smoke(arch), torch_smoke(arch)
    pn = _open_gates(jax.tree.map(
        np.array, JM.init_params(jcfg, jax.random.PRNGKey(seed))))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, pn), params_from_jax(pn,
                                                                      tcfg)


def _enc_embeds(cfg, B, seed=5):
    """The stubbed frontend's output of a batch of ``B`` for ``cfg``, fp32
    standard normals (None for a family without one)."""
    if cfg.family not in TM.ENCODER_FAMILIES:
        return None
    T = cfg.num_patches if cfg.family == "vlm" else cfg.encoder_seq
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)



def _enc_out_jax(pj, jcfg, enc):
    if enc is None:
        return None
    if jcfg.family == "vlm":
        return jnp.asarray(enc).astype(JM.ACT_DTYPE)
    return jax.jit(lambda p, e: JM.encoder_forward(p, jcfg, e))(
        pj, jnp.asarray(enc))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_matches_jax_fp32(arch, fp32_activations):
    """The smoke config, a (2, 70) prompt (recurrentgemma's 64-slot window
    ring wraps), 4 greedy steps of the JAX stream teacher-forced: the
    prefill logits and every cache leaf (k/v and positions, RG-LRU's h
    and conv history, RWKV's S and x_prev, whisper's self-attention k/v;
    a vlm cross-attention layer's empty entry) after the prefill and
    after the decode, and each step's logits. The vlm and audio families
    prefill from ``enc_embeds`` and decode against the reference's
    ``enc_out``; the port decodes against its own."""
    jcfg, tcfg, pj, pt = _model_params(arch)
    pt = TM.serving_params(pt)
    B, S, G = 2, 70, 4
    prompt = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    enc = _enc_embeds(jcfg, B)
    kj = {} if enc is None else {"enc_embeds": jnp.asarray(enc)}
    kt = {} if enc is None else {"enc_embeds": torch.from_numpy(enc)}
    eoj = _enc_out_jax(pj, jcfg, enc)
    eot = TM.encoder_stream(pt, tcfg, kt.get("enc_embeds"))
    lj, cj = jax.jit(lambda p, t: JM.prefill_with_cache(p, jcfg, t, S + G,
                                                        **kj))(
        pj, jnp.asarray(prompt))
    step = jax.jit(lambda c, t, q: JM.decode_step(pj, jcfg, c, t, q,
                                                  enc_out=eoj))
    lt, ct = TM.prefill_with_cache(pt, tcfg, torch.from_numpy(prompt).long(),
                                   S + G, **kt)

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
                                torch.full((B,), t), enc_out=eot)
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
            if n.split("/")[-1] in ("lam", "w0", "u", "norm", "ffn_norm",
                                    "xnorm", "gate", "final_norm") \
                    or n.split("/")[-1].startswith("mu_"):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=n)


@pytest.mark.parametrize("arch", sorted(ARCH_NAMES))
def test_only_the_encoder_families_are_refused_by_the_train_driver(arch):
    """The train driver builds token shards only, so it refuses the vlm
    and audio families, whose likelihood reads enc_embeds (as the
    reference's driver cannot carry them), naming the facade; it parses
    every other arch, and the model builds every arch's layout."""
    TM.param_layout(torch_smoke(arch))
    if torch_smoke(arch).family in TM.ENCODER_FAMILIES:
        with pytest.raises(SystemExit, match="enc_embeds.*api.FSGLD"):
            ttrain.parse_args(["--arch", arch, "--smoke", "--device", "cpu"])
    else:
        assert ttrain.parse_args(["--arch", arch]).arch == arch


def test_an_encoder_outside_the_audio_family_is_refused():
    """Only the audio family's decoder reads an encoder's output (an
    'xattn' layer outside vlm and audio:
    ``test_torch_train_loglik_fp32.py``)."""
    cfg = dataclasses.replace(torch_smoke("qwen3-1.7b"), encoder_layers=1)
    with pytest.raises(ValueError, match="audio family"):
        TM.param_layout(cfg)


# ---------------------------------------------------------------------------
# cross-attention and the encoder (vlm, audio)
# ---------------------------------------------------------------------------

def test_encoder_forward_matches_jax(fp32_activations):
    """whisper's smoke encoder (2 layers, 32 frames, d 256) on (2, 32,
    256) frames: the output within 1e-5 of the largest."""
    jcfg, tcfg, pj, pt = _model_params("whisper-large-v3")
    enc = _enc_embeds(jcfg, 2)
    want = _enc_out_jax(pj, jcfg, enc)
    _close(TM.encoder_forward(pt, tcfg, torch.from_numpy(enc)), want)


def _batch_pair(jcfg, B=2, S=24, seed=3):
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    enc = _enc_embeds(jcfg, B)
    bj = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]), "enc_embeds": jnp.asarray(enc)}
    bt = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long(),
          "enc_embeds": torch.from_numpy(enc)}
    return bj, bt


@pytest.mark.parametrize("arch", ENC_ARCHS)
def test_forward_and_log_lik_with_enc_embeds_match_jax(arch,
                                                       fp32_activations):
    """(2, 24) tokens and their enc_embeds: the hidden states within 1e-5
    of the largest and ``log_lik_fn`` within 1e-6 relative. The frames
    move the output (the vlm's through its opened gates): other
    enc_embeds give other hidden states."""
    jcfg, tcfg, pj, pt = _model_params(arch)
    bj, bt = _batch_pair(jcfg)
    hj, _ = jax.jit(lambda p, b: JM.forward(
        p, jcfg, b["tokens"], enc_embeds=b["enc_embeds"]))(pj, bj)
    ht, _ = TM.forward(pt, tcfg, bt["tokens"], enc_embeds=bt["enc_embeds"])
    _close(ht, hj)
    other, _ = TM.forward(pt, tcfg, bt["tokens"], enc_embeds=torch.from_numpy(
        _enc_embeds(jcfg, 2, seed=6)))
    assert not torch.allclose(other, ht, rtol=0, atol=1e-3)
    lj = jax.jit(lambda p, b: JM.log_lik_fn(p, jcfg, b))(pj, bj)
    assert abs(float(TM.log_lik_fn(pt, tcfg, bt)) / float(lj) - 1) < 1e-6


@pytest.mark.parametrize("arch", ENC_ARCHS)
def test_log_lik_grad_with_enc_embeds_matches_jax(arch, fp32_activations):
    """``torch.func.grad`` of ``log_lik_fn`` against ``jax.grad``: every
    leaf within 1e-5 of its largest (measured: at most 2e-6), and the
    encoder's, the cross-attention's and the vlm gate's nonzero (a vlm
    'xattn' layer's ``norm`` is unused, its gradient 0 in both)."""
    jcfg, tcfg, pj, pt = _model_params(arch)
    bj, bt = _batch_pair(jcfg)
    gj = jax.jit(jax.grad(lambda p: JM.log_lik_fn(p, jcfg, bj)))(pj)
    gt = grad(lambda p: TM.log_lik_fn(p, tcfg, bt))(pt)
    names = [n for n, _ in tu.leaves_with_names(gt)]
    assert any("encoder" in n for n in names) == (arch == ENC_ARCHS[1])
    for n, a, b in zip(names, tu.leaves(gt), jax.tree.leaves(gj)):
        assert a.dtype == torch.float32, n
        if any(w in n for w in ("xattn", "xnorm", "encoder")):
            assert float(np.abs(np.asarray(b)).max()) > 0, n
        _close(a, b)


PARITY_ARCHS = ("qwen3-1.7b", "h2o-danube-1.8b", "llama-3.2-vision-90b",
                "whisper-large-v3", "recurrentgemma-2b", "rwkv6-7b")


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_prefill_decode_parity(arch):
    """The port in bf16, as it runs: the full-sequence forward's logits
    and those of decoding the same (2, 24) tokens one at a time from an
    empty cache agree within 5e-2 of the largest (the reference's
    ``test_archs.py::test_prefill_decode_parity``); the vlm decodes
    against the bf16 patches, whisper against ``encoder_forward``."""
    cfg = torch_smoke(arch)
    gen = torch.Generator().manual_seed(1)
    params = TM.init_params(cfg, gen)
    if cfg.family == "vlm":
        params = params_from_jax(_open_gates(tu.tree_map(
            lambda t: t.numpy(), params)), cfg)
    B, S = 2, 24
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    enc = None if cfg.family not in TM.ENCODER_FAMILIES else torch.randn(
        (B, cfg.num_patches or cfg.encoder_seq, cfg.d_model), generator=gen)
    hidden, _ = TM.forward(params, cfg, tokens, enc_embeds=enc)
    full = hidden.float() @ params["head"].to(torch.bfloat16).float()
    served = TM.serving_params(params)
    enc_out = TM.encoder_stream(served, cfg, enc)
    cache = TM.init_cache(cfg, B, S)
    steps = [TM.decode_step(served, cfg, cache, tokens[:, t:t + 1],
                            torch.full((B,), t), enc_out=enc_out)[0]
             for t in range(S)]
    dec = torch.stack(steps, 1)
    rel = float((full - dec).abs().max() / full.abs().max())
    assert rel < 0.05, rel


@pytest.mark.parametrize("arch", ENC_ARCHS)
def test_layouts_match_the_reference_at_full_width(arch):
    """``param_layout`` at the published width (llama-3.2-vision at one
    period, 5 of 100 layers: 4 'attn' and 1 gated 'xattn') against the
    shapes of the reference's ``init_params`` (``jax.eval_shape``: no
    parameter is made), leaf by leaf, names included: whisper's 25 leaves
    hold 1,600,990,720 parameters, the vision period 6,379,634,689."""
    import math
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    if arch.startswith("llama"):
        jcfg = dataclasses.replace(jcfg, num_layers=5)
        tcfg = dataclasses.replace(tcfg, num_layers=5)
    want = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    got = tu.leaves_with_names(TM.param_layout(tcfg))
    paths = [jax.tree_util.keystr(k, simple=True, separator="/")
             for k, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [n for n, _ in got] == paths
    for (n, leaf), w in zip(got, jax.tree.leaves(want)):
        assert tuple(leaf.shape) == w.shape, n
    total = sum(math.prod(leaf.shape) for _, leaf in got)
    assert (len(got), total) == {"whisper-large-v3": (25, 1_600_990_720),
                                 "llama-3.2-vision-90b": (50, 6_379_634_689)
                                 }[arch]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_make_batch_has_the_reference_keys_shapes_and_dtypes(arch):
    """At the smoke configs and a (3, 12) input shape: the same keys,
    shapes and dtypes as the reference's ``make_batch`` (int32 tokens
    and labels in the vocabulary; bf16 enc_embeds for vlm and audio);
    the draws come from the generator."""
    shape = dict(name="t", seq_len=12, global_batch=3, kind="train")
    want = jax_make_batch(jax_smoke(arch), JShape(**shape),
                          jax.random.PRNGKey(0))
    got = make_batch(torch_smoke(arch), TShape(**shape),
                     torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        assert tuple(got[n].shape) == w.shape, n
        assert str(got[n].dtype) == f"torch.{w.dtype}", n
    assert 0 <= int(got["tokens"].min()) and \
        int(got["tokens"].max()) < torch_smoke(arch).vocab_size
    again = make_batch(torch_smoke(arch), TShape(**shape),
                       torch.Generator().manual_seed(0))
    assert all(torch.equal(got[n], again[n]) for n in got)


def test_a_facade_round_with_enc_embeds_packed_equals_per_leaf():
    """whisper's smoke posterior through ``api.FSGLD`` with an
    'enc_embeds' leaf in the shards (each row's frames, gathered with its
    tokens by the engine): a bf16 'scalar' bank fitted by local SGLD, C =
    2, one round of 2 steps, bf16 activations; the packed and per_leaf
    executors end in the same states, bitwise, and the chains moved."""
    cfg = torch_smoke("whisper-large-v3")
    theta0 = TM.init_params(cfg, torch.Generator().manual_seed(0))
    data = token_shards(torch.Generator().manual_seed(1), num_shards=2,
                        shard_size=3, seq_len=8, vocab_size=cfg.vocab_size)
    frames = make_batch(cfg, TShape("t", seq_len=8, global_batch=6,
                                    kind="train"),
                        torch.Generator().manual_seed(2))["enc_embeds"]
    data["enc_embeds"] = frames.reshape((2, 3) + tuple(frames.shape[1:]))
    ll = lambda p, b: TM.log_lik_fn(p, cfg, b)  # noqa: E731
    bank = api.fit_bank_local_sgld(ll, data, theta0,
                                   torch.Generator().manual_seed(3),
                                   fit_steps=2, minibatch=2, step_size=1e-5,
                                   store_dtype=torch.bfloat16)
    out = {}
    for ex in ("packed", "per_leaf"):
        s = api.FSGLD(
            api.Posterior(ll, prior_precision=1.0), data, minibatch=2,
            step_size=1e-5,
            surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
            schedule=api.Schedule(rounds=1, local_steps=2, n_chains=2,
                                  reassign="permutation"),
            execution=api.Execution(device="cpu", executor=ex,
                                    collect=False, dtype=torch.bfloat16))
        out[ex] = s.sample(torch.Generator().manual_seed(4), theta0)
    moved = False
    for (n, a), b, t0 in zip(tu.leaves_with_names(out["packed"]),
                             tu.leaves(out["per_leaf"]), tu.leaves(theta0)):
        assert a.shape == (2,) + t0.shape and torch.equal(a, b), n
        moved = moved or not torch.equal(a[0], t0)
    assert moved and len(tu.leaves(theta0)) == 25
