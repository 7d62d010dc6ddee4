"""The port's serving path against the JAX package's, at the smoke configs
of qwen3-1.7b (GQA, qk_norm, full attention), h2o-danube-1.8b (sliding
window: the prompt plus generation outruns the 64-slot ring cache),
phi3.5-moe and grok-1 (MoE FFN), recurrentgemma-2b (RG-LRU states and a
64-slot window), rwkv6-7b (RWKV-6 states), llama-3.2-vision (gated
cross-attention to image patches, every gate set to 0.5: at init a gate
is 0 and hides the cross-attention) and whisper (the audio encoder and
cross-attention), the last two with the same numpy patches or frames.

JAX parameters are carried across by ``convert.params_from_jax``; the
same numpy prompt goes to both. Tolerances: logits and cache entries are
held to 5e-2 of their largest magnitude, the yardstick of
``tests/test_prefill_cache.py`` (bf16 activations through two layers; XLA
and torch round silu and exp differently in bf16, a few bf16 ulps of 2^-8
each: about 1.5e-2 here); predictive statistics of the same fp32 logits to
1e-5; the port's own K=1 ensemble against its own plain loop bitwise.
(Measured on the new families: at most 2.4e-2, recurrentgemma's last
step.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.configs import ARCH_NAMES as jax_arch_names
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.serve import predictive_stats as jax_predictive_stats
from repro_torch import api, convert
from repro_torch import models as TM
from repro_torch import tree as tu
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import (EnsembleServer, ensemble_prefill,
                               predictive_stats)
from test_torch_models import _enc_embeds, _enc_out_jax, _open_gates
from _torch_train_common import fp32_activations  # noqa: F401 (fixture)
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

ARCHS = ["qwen3-1.7b", "h2o-danube-1.8b", "phi3.5-moe-42b-a6.6b",
         "grok-1-314b", "recurrentgemma-2b", "rwkv6-7b",
         "llama-3.2-vision-90b", "whisper-large-v3"]
NEW_ARCHS = ARCHS[2:]
B, S, GEN = 2, 80, 6
REL = 5e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _f32(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """JAX params, prompt, prefill and a greedy JAX decode stream, traced
    once per arch."""
    arch = request.param
    jc, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp = jax.tree.map(jnp.asarray, _open_gates(jax.tree.map(
        np.array, JM.init_params(jc, jax.random.PRNGKey(0)))))
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    total = S + GEN
    enc = _enc_embeds(cfg, B)
    kw = {} if enc is None else {"enc_embeds": jnp.asarray(enc)}
    logits, cache = JM.prefill_with_cache(jp, jc, jnp.asarray(prompt), total,
                                          **kw)
    enc_out = _enc_out_jax(jp, jc, enc)
    step = jax.jit(lambda c, t, p: JM.decode_step(jp, jc, c, t, p,
                                                  enc_out=enc_out))
    tokens = [np.asarray(jnp.argmax(logits, -1))]
    step_logits = []
    c = cache
    for t in range(S, total - 1):
        lg, c = step(c, jnp.asarray(tokens[-1][:, None]),
                     jnp.full((B,), t, jnp.int32))
        step_logits.append(np.asarray(lg))
        tokens.append(np.asarray(jnp.argmax(lg, -1)))
    return dict(cfg=cfg, params=TM.serving_params(convert.params_from_jax(
                    jax.tree.map(np.asarray, jp), cfg)),
                prompt=prompt, total=total, logits=np.asarray(logits),
                enc=None if enc is None else torch.from_numpy(enc),
                cache=jax.tree.map(_f32, cache),
                cache_dtypes=[str(t.dtype) for t in jax.tree.leaves(cache)],
                tokens=tokens,
                step_logits=step_logits)


@pytest.fixture(scope="module")
def plain_stream(case):
    """The port's own greedy stream on one draw, made once per arch: the
    prefill's logits and cache (a copy taken before decoding writes into
    it) and each step's tokens and logits."""
    cfg, params, enc = case["cfg"], case["params"], case["enc"]
    enc_out = TM.encoder_stream(params, cfg, enc)
    logits, cache = TM.prefill_with_cache(
        params, cfg, torch.from_numpy(case["prompt"]).long(), case["total"],
        enc_embeds=enc)
    prefilled = tu.tree_map(torch.clone, cache)
    tokens = [torch.argmax(logits, -1)]
    step_logits = []
    for t in range(S, case["total"] - 1):
        lg, cache = TM.decode_step(params, cfg, cache, tokens[-1][:, None],
                                   torch.full((B,), t), enc_out=enc_out)
        step_logits.append(lg)
        tokens.append(torch.argmax(lg, -1))
    return dict(logits=logits, cache=prefilled, enc_out=enc_out,
                tokens=tokens, step_logits=step_logits)


def test_prefill_logits_and_cache_match_jax(case, plain_stream):
    cfg = case["cfg"]
    logits, cache = plain_stream["logits"], plain_stream["cache"]
    assert logits.dtype == torch.float32
    assert _rel(logits.numpy(), case["logits"]) < REL
    jl, jd = jax.tree.flatten(case["cache"])
    tl = tu.leaves(cache)
    assert len(jl) == len(tl)
    for a, b, dtype in zip(tl, jl, case["cache_dtypes"]):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype) == f"torch.{dtype}"
        if a.dtype == torch.int32:  # positions: exact
            np.testing.assert_array_equal(a.numpy(), b)
        else:  # k/v, conv history, x_prev in bf16; h and S in fp32
            assert _rel(a.float().numpy(), b) < REL


def test_teacher_forced_decode_matches_jax(case, plain_stream):
    """Decode fed JAX's own greedy stream, so a bf16 argmax tie cannot
    fork the comparison, from the prefill's cache (a copy: decoding
    writes into it)."""
    cfg, params = case["cfg"], case["params"]
    enc_out = plain_stream["enc_out"]
    cache = tu.tree_map(torch.clone, plain_stream["cache"])
    for i, t in enumerate(range(S, case["total"] - 1)):
        tok = torch.tensor(case["tokens"][i][:, None], dtype=torch.long)
        lg, cache = TM.decode_step(params, cfg, cache, tok,
                                   torch.full((B,), t), enc_out=enc_out)
        assert _rel(lg.numpy(), case["step_logits"][i]) < REL, t


@pytest.mark.parametrize("K", [1, 4])
def test_predictive_stats_match_jax(K):
    logits = np.random.default_rng(K).standard_normal(
        (K, 3, 97)).astype(np.float32) * 3
    want = jax_predictive_stats(jnp.asarray(logits))
    got = predictive_stats(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.token.numpy(), np.asarray(want.token))
    for f in ("mean_logprob", "entropy", "mutual_info", "token_var"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   rtol=1e-5, err_msg=f)
    if K == 1:
        assert torch.all(got.mutual_info == 0)
        assert torch.all(got.token_var == 0)


def test_k1_ensemble_bitwise_matches_plain_loop(case, plain_stream):
    cfg, params, enc = case["cfg"], case["params"], case["enc"]
    prompt = torch.from_numpy(case["prompt"]).long()
    total = case["total"]
    enc_out = plain_stream["enc_out"]
    want_tok = plain_stream["tokens"]
    want_logits = plain_stream["step_logits"]

    draws = tu.tree_map(lambda t: t[None], params)
    logits0, caches = ensemble_prefill(draws, cfg, prompt, total,
                                       enc_out=enc_out)
    tok = predictive_stats(logits0[None]).token[:, None]
    for i, t in enumerate(range(S, total - 1)):
        lk, caches = TM.ensemble_decode_step(draws, cfg, caches, tok,
                                             torch.full((B,), t),
                                             enc_out=enc_out)
        assert torch.equal(lk[0], want_logits[i])
        tok = predictive_stats(lk).token[:, None]

    res = EnsembleServer(cfg, draws=draws, device="cpu").generate(
        prompt, gen=GEN, enc_embeds=enc)
    assert torch.equal(res.tokens, torch.stack(want_tok, 1))
    assert torch.all(res.mutual_info == 0)
    assert torch.all(res.token_var == 0)


def test_distinct_draws_disagree(case):
    """K=3 draws (JAX inits, stacked and carried across): finite signals,
    zero epistemic uncertainty at the anchor's token 0, positive after."""
    cfg = case["cfg"]
    jc = jax_smoke_config(cfg.name)
    stacked = _open_gates(jax.tree.map(
        lambda *ls: np.stack(ls),
        *[jax.tree.map(np.asarray, JM.init_params(jc, jax.random.PRNGKey(s)))
          for s in range(3)]))
    srv = EnsembleServer(cfg, draws=convert.draws_from_jax(stacked, cfg),
                         device="cpu")
    assert srv.n_draws == 3
    res = srv.generate(torch.from_numpy(case["prompt"][:, :16]).long(),
                       gen=4, enc_embeds=case["enc"])
    assert res.tokens.shape == (B, 4)
    for f in (res.mean_logprob, res.entropy, res.mutual_info,
              res.token_var):
        assert torch.isfinite(f).all()
    assert torch.all(res.mutual_info[:, 0] == 0)
    assert torch.all(res.mutual_info[:, 1:] > 0)


def test_serving_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.Serving()
    spec = api.Serving(device="cpu", draws=2, arch="h2o-danube-1.8b")
    assert spec.device == torch.device("cpu")
    srv = api.FSGLD.serve(spec, seed=3)
    res = srv.generate(gen=3, batch=2, prompt_len=5)
    assert srv.n_draws == 2 and res.tokens.shape == (2, 3)
    assert all(t.device.type == "cpu" for t in tu.leaves(srv.draws))


def test_cli_serves_on_the_cpu(capsys, monkeypatch):
    argv = ["--smoke", "--draws", "2", "--batch", "2", "--prompt-len", "6",
            "--gen", "3"]
    assert serve_cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "MI" in out
    assert "for 2 draw(s) on cpu" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(argv)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_serves_every_decoder_family(arch, capsys):
    assert serve_cli.main(["--smoke", "--arch", arch, "--draws", "2",
                           "--batch", "2", "--prompt-len", "6", "--gen", "3",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "for 2 draw(s) on cpu" in out


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b"])
def test_fresh_draws_are_the_cast_inits(arch):
    """A server's fresh draws, written leaf by leaf into the stack, are
    ``serving_params`` of ``init_params`` on the same generator, bitwise
    (final_norm in the parameter dtype, the head widened from bf16)."""
    cfg = get_smoke_config(arch)
    srv = EnsembleServer(cfg, n_draws=2, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    want = [TM.serving_params(TM.init_params(cfg, gen)) for _ in range(2)]
    for (n, a), *ws in zip(tu.leaves_with_names(srv.draws),
                           *[tu.leaves(w) for w in want]):
        assert a.dtype == ws[0].dtype, n
        assert torch.equal(a, torch.stack(ws)), n


def _whisper_draws(k=2):
    """(JAX config, port config, k stacked JAX inits as numpy, the frames
    of a batch of B, a (B, 12) prompt) at whisper's smoke config."""
    jc, cfg = (jax_smoke_config("whisper-large-v3"),
               get_smoke_config("whisper-large-v3"))
    stacked = jax.tree.map(
        lambda *ls: np.stack(ls),
        *[jax.tree.map(np.asarray, JM.init_params(jc, jax.random.PRNGKey(s)))
          for s in range(k)])
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, 12)).astype(np.int32)
    return jc, cfg, stacked, _enc_embeds(cfg, B, seed=7), prompt


def test_a_whisper_request_equals_the_reference_servers(fp32_activations):
    """K = 2 draws, the same prompt and injected frames (the reference's
    ``_encoder_inputs`` replaced by them), both packages in fp32
    activations: the same tokens, each signal within 1e-5 of its largest
    (the same fp32 arithmetic in another order)."""
    from repro.serve import EnsembleServer as JServer
    jc, cfg, stacked, enc, prompt = _whisper_draws()
    jsrv = JServer(jc, draws=jax.tree.map(jnp.asarray, stacked))
    anchor = jax.tree.map(lambda t: t[0], jsrv.draws)
    jsrv._encoder_inputs = lambda key, batch: (
        jnp.asarray(enc), JM.encoder_forward(anchor, jc, jnp.asarray(enc)))
    want = jsrv.generate(jnp.asarray(prompt), gen=GEN)
    got = EnsembleServer(cfg, draws=convert.draws_from_jax(stacked, cfg),
                         device="cpu").generate(
        torch.from_numpy(prompt).long(), gen=GEN,
        enc_embeds=torch.from_numpy(enc))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    for f in ("mean_logprob", "entropy", "mutual_info", "token_var"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f)


def test_the_encoder_runs_once_per_request(monkeypatch):
    """The port encodes a request's frames once, on the anchor, and hands
    the output to the prefill (the reference encodes them again inside
    ``prefill_with_cache``): one ``encoder_forward`` call per request; the
    anchor's prefill from that ``enc_out`` equals the prefill from the
    frames bitwise, and the reference's two-pass prefill (the encoder
    inside it) within ``REL`` in logits and every cache leaf (bf16, as
    served)."""
    import repro_torch.serve.server as tserver
    jc, cfg, stacked, enc, prompt = _whisper_draws()
    calls = []
    real = tserver.encoder_stream
    monkeypatch.setattr(tserver, "encoder_stream",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    srv = EnsembleServer(cfg, draws=convert.draws_from_jax(stacked, cfg),
                         device="cpu")
    srv.generate(torch.from_numpy(prompt).long(), gen=3,
                 enc_embeds=torch.from_numpy(enc))
    assert len(calls) == 1
    anchor = tu.tree_map(lambda t: t[0], srv.draws)
    tok = torch.from_numpy(prompt).long()
    once = TM.prefill_with_cache(anchor, cfg, tok, 16, enc_out=real(
        anchor, cfg, torch.from_numpy(enc)))
    twice = TM.prefill_with_cache(anchor, cfg, tok, 16,
                                  enc_embeds=torch.from_numpy(enc))
    for a, b in zip(tu.leaves(once), tu.leaves(twice)):
        assert torch.equal(a, b)
    jl, jcache = JM.prefill_with_cache(
        jax.tree.map(lambda t: jnp.asarray(t[0]), stacked), jc,
        jnp.asarray(prompt), 16, enc_embeds=jnp.asarray(enc))
    assert _rel(once[0].numpy(), jl) < REL
    for a, b in zip(tu.leaves(once[1]), jax.tree.leaves(jcache)):
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert _rel(a.float().numpy(), _f32(b)) < REL


def test_unported_serving_options_are_refused():
    """Every serving option is ported (``--log-jsonl``, item 12, runs:
    tests/test_torch_obs.py; ``Serving(mesh=)``, item 8:
    tests/test_torch_mesh.py); a mesh that is not a DeviceMesh with a
    'data' axis is refused."""
    with pytest.raises(ValueError, match="'data' axis"):
        api.Serving(device="cpu", mesh=object())


@pytest.mark.parametrize("argv", [["--bank", "/nonexistent"],
                                  ["--ckpt", "/nonexistent"]])
def test_a_missing_bank_is_refused_naming_it(argv):
    """Draw banks are served (``tests/test_torch_checkpoint.py``); one
    that does not exist is refused up front, by the CLI and the server."""
    with pytest.raises(ValueError, match="no draws in bank"):
        serve_cli.main(["--smoke", "--device", "cpu"] + argv)
    cfg = get_smoke_config("h2o-danube-1.8b")
    with pytest.raises(ValueError, match="no draws in bank"):
        EnsembleServer(cfg, bank="/nonexistent", device="cpu")


@pytest.mark.parametrize("arch", sorted(jax_arch_names))
def test_configs_match_the_reference(arch):
    """The registry is a copy of the JAX package's data: every field of
    the published and the smoke config, and the analytic counts."""
    for get_t, get_j in ((get_config, jax_config),
                         (get_smoke_config, jax_smoke_config)):
        t, j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert set(ARCH_NAMES) == set(jax_arch_names)


def test_params_from_jax_checks_the_layout():
    cfg = get_smoke_config("qwen3-1.7b")
    like = tu.tree_map(lambda leaf: np.zeros(leaf.shape, np.float32),
                       TM.param_layout(cfg))
    assert tu.leaves(convert.params_from_jax(like, cfg))[0].dtype == \
        torch.float32
    like["head"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="leaf of shape"):
        convert.params_from_jax(like, cfg)
    del like["head"]
    with pytest.raises(ValueError, match="layout"):
        convert.params_from_jax(like, cfg)
