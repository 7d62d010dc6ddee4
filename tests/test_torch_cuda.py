"""The CUDA kernels on the card: each held against its plain PyTorch
version, launched where its path should launch it (the fused update once
per step by the packed executor, flash attention once per layer of a
serving prefill), and refusing operands they cannot take. Needs a CUDA
card and nvcc; elsewhere every test here skips (the decision is made in a
fixture, at run time). Run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Update tolerance 1e-5 absolute + relative: the kernel and the plain version
evaluate the same float32 expressions, but nvcc contracts multiply-adds
into FMAs and CUDA's logf/cosf may differ from torch's in the last ulp.
"""
import pytest
import torch

from repro_torch import api
from repro_torch import tree as tu
from repro_torch.kernels import fsgld_update as fk
from repro_torch.kernels import ops as kops
from repro_torch.workloads import mlp_log_lik, mlp_problem
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(dev, rows, shared, variant, dynamics, L, C):
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    ops = {}
    if variant != "plain":
        ops.update(mu_g=rn(shared, 128), mu_s=rn(rows, 128))
    if variant == "diag":
        ops.update(lam_g=rn(shared, 128).abs(), lam_s=rn(rows, 128).abs())
    if dynamics == "sghmc":
        ops["r2d"] = rn(rows, 128)
    seeds = torch.randint(0, 2**31 - 1, (C, L), generator=g, device=dev)
    return rn(rows, 128), rn(rows, 128), seeds, rn(C, L, 9).abs() * 0.1, ops


def _pair(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("variant", fk.VARIANTS)
@pytest.mark.parametrize("dynamics", fk.DYNAMICS)
def test_kernel_matches_plain_version(dev, variant, dynamics):
    layout = kops.make_packed_layout({"a": torch.zeros(1500),
                                      "b": torch.zeros(7, 11),
                                      "c": torch.zeros(3)})
    C = 3
    th, g, seeds, sc, ops = _operands(dev, C * layout.rows_total,
                                      layout.rows_total, variant, dynamics,
                                      layout.num_leaves, C)
    sl, sb = layout.tables(dev)
    kw = dict(variant=variant, dynamics=dynamics, seg_leaf=sl, seg_base=sb,
              chains=C, block_rows=layout.block_rows, **ops)
    ref = fk.fsgld_update_packed_plain(th, g, seeds, sc, **kw)
    fk.reset_launches()
    out = fk.fsgld_update_packed(th, g, seeds, sc, **kw)  # in place
    assert fk.LAUNCHES["fsgld_update_packed"] == 1
    assert _pair(out)[0] is th
    for a, b in zip(_pair(out), _pair(ref)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

    rows_c = 512
    th, g, seeds, sc, ops = _operands(dev, C * rows_c, rows_c, variant,
                                      dynamics, 1, C)
    kw = dict(variant=variant, dynamics=dynamics, chains=C, **ops)
    out = fk.fsgld_update_2d(th, g, seeds[:, 0], sc[:, 0], **kw)
    ref = fk.fsgld_update_2d_plain(th, g, seeds[:, 0], sc[:, 0], **kw)
    assert fk.LAUNCHES["fsgld_update_2d"] == 1
    for a, b in zip(_pair(out), _pair(ref)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _entry_out_of_place(th, g, seeds, sc, ops, *, variant, dynamics,
                        seg_leaf, seg_base, block_rows, num_leaves):
    """The kernel through its C entry into new buffers (the wrappers fix
    the packed entry in place and the per-leaf one out of place)."""
    import ctypes
    from repro_torch.kernels import _build
    hmc = dynamics == "sghmc"
    out = torch.empty_like(th)
    r_out = torch.empty_like(ops["r2d"]) if hmc else None
    p = fk._ptr
    err = _build.load("fsgld_update").fsgld_update_launch(
        fk.VARIANTS.index(variant), int(hmc), p(th), p(ops.get("r2d")), p(g),
        p(ops.get("mu_g")), p(ops.get("mu_s")), p(ops.get("lam_g")),
        p(ops.get("lam_s")), p(seg_leaf, 4), p(seg_base, 4),
        p(fk._seeds_i32(seeds), 4), p(sc.contiguous(), 4), p(out), p(r_out),
        th.shape[0], len(seg_leaf) * block_rows, block_rows, num_leaves,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0
    return (out, r_out) if hmc else (out,)


def _smoke_qwen3_layout():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import param_layout
    return kops.make_packed_layout(tu.tree_map(
        lambda leaf: torch.empty(leaf.shape, device="meta"),
        param_layout(get_smoke_config("qwen3-1.7b"))))


# The walk's edges: (layout, chains). 'ragged3' has 3-row blocks, so its
# leaves end inside a tile of 8 rows and its 18 rows per chain are no
# multiple of one; qwen3's smoke layout at C = 48 has 672 (chain, leaf)
# pairs, more than a CTA stages in shared memory (256).
WALK_CASES = [("ragged3", C) for C in (1, 3, 8)] + \
    [("table1", C) for C in (1, 3, 8)] + [("qwen3-smoke", 48)]


@pytest.mark.parametrize("variant", fk.VARIANTS)
@pytest.mark.parametrize("dynamics", fk.DYNAMICS)
@pytest.mark.parametrize("case,C", WALK_CASES)
def test_chain_walk_matches_plain_in_and_out_of_place(dev, variant,
                                                      dynamics, case, C):
    """The packed entry at the walk's edges: out of place through the C
    entry against the plain version, in place through the wrapper
    bitwise the out-of-place result."""
    layout = {"ragged3": lambda: kops.make_packed_layout(
                  {"a": torch.zeros(1500), "b": torch.zeros(7, 11),
                   "c": torch.zeros(3)}, block_rows=3),
              "table1": lambda: kops.make_packed_layout(torch.zeros(854)),
              "qwen3-smoke": _smoke_qwen3_layout}[case]()
    th, g, seeds, sc, ops = _operands(dev, C * layout.rows_total,
                                      layout.rows_total, variant, dynamics,
                                      layout.num_leaves, C)
    sl, sb = layout.tables(dev)
    kw = dict(variant=variant, dynamics=dynamics, seg_leaf=sl, seg_base=sb,
              block_rows=layout.block_rows)
    ref = _pair(fk.fsgld_update_packed_plain(th, g, seeds, sc, chains=C,
                                             **kw, **ops))
    out = _entry_out_of_place(th, g, seeds, sc, ops, **kw,
                              num_leaves=layout.num_leaves)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    got = _pair(fk.fsgld_update_packed(th, g, seeds, sc, chains=C, **kw,
                                       **ops))
    for a, b in zip(got, out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", fk.VARIANTS)
@pytest.mark.parametrize("dynamics", fk.DYNAMICS)
@pytest.mark.parametrize("C", [1, 3, 8])
def test_per_leaf_entry_on_a_ragged_chain_in_and_out_of_place(
        dev, variant, dynamics, C):
    """A chain of 13 rows (no multiple of a tile's 8): the per-leaf entry
    against its plain version, and in place through the C entry bitwise
    its out-of-place result."""
    rows_c = 13
    th, g, seeds, sc, ops = _operands(dev, C * rows_c, rows_c, variant,
                                      dynamics, 1, C)
    kw = dict(variant=variant, dynamics=dynamics, chains=C, **ops)
    out = _pair(fk.fsgld_update_2d(th, g, seeds[:, 0], sc[:, 0], **kw))
    ref = _pair(fk.fsgld_update_2d_plain(th, g, seeds[:, 0], sc[:, 0], **kw))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    sl, sb = fk._one_leaf_tables(dev, 1, rows_c)
    got = _entry_out_of_place(th, g, seeds, sc, ops, variant=variant,
                              dynamics=dynamics, seg_leaf=sl, seg_base=sb,
                              block_rows=rows_c, num_leaves=1)
    for a, b in zip(got, out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", fk.VARIANTS)
@pytest.mark.parametrize("dynamics", fk.DYNAMICS)
def test_packed_equals_per_leaf_bitwise_at_three_chains(dev, variant,
                                                        dynamics):
    """At C = 3 on 'ragged3', each leaf's rows of the packed launch equal
    bitwise that leaf's own per-leaf launch (its seeds, scalars and block
    table)."""
    C = 3
    layout = kops.make_packed_layout({"a": torch.zeros(1500),
                                      "b": torch.zeros(7, 11),
                                      "c": torch.zeros(3)}, block_rows=3)
    th, g, seeds, sc, ops = _operands(dev, C * layout.rows_total,
                                      layout.rows_total, variant, dynamics,
                                      layout.num_leaves, C)
    sl, sb = layout.tables(dev)
    by_chain = lambda t: t.reshape(C, layout.rows_total, 128)  # noqa: E731
    leaf_rows = []
    for li, (off, rows) in enumerate(zip(layout.row_offsets, layout.rows)):
        cut = lambda t: by_chain(t)[:, off:off + rows].reshape(  # noqa: E731
            C * rows, 128).contiguous()
        lops = {k: (v[off:off + rows].contiguous() if k in ("mu_g", "lam_g")
                    else cut(v)) for k, v in ops.items()}
        leaf_rows.append(_pair(fk.fsgld_update_2d(
            cut(th), cut(g), seeds[:, li], sc[:, li], variant=variant,
            dynamics=dynamics, chains=C, block_rows=layout.block_rows,
            **lops)))
    packed = _pair(fk.fsgld_update_packed(
        th, g, seeds, sc, variant=variant, dynamics=dynamics, seg_leaf=sl,
        seg_base=sb, block_rows=layout.block_rows, chains=C, **ops))
    for k, whole in enumerate(packed):
        for (off, rows), got in zip(zip(layout.row_offsets, layout.rows),
                                    leaf_rows):
            assert torch.equal(by_chain(whole)[:, off:off + rows],
                               got[k].reshape(C, rows, 128))


def test_kernel_refuses_misaligned_and_cpu_operands(dev):
    x = torch.zeros(16 * 128 + 1, device=dev)[1:].reshape(16, 128)
    seeds = torch.zeros(2, dtype=torch.int64, device=dev)
    sc = torch.zeros(2, 9, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        fk.fsgld_update_2d(x, x, seeds, sc, chains=2)
    y = torch.zeros(16, 128, device=dev)
    with pytest.raises(ValueError, match="g2d is on cpu"):
        fk.fsgld_update_2d(y, torch.zeros(16, 128), seeds, sc, chains=2)


def test_packed_executor_one_launch_per_step_and_equals_per_leaf(dev):
    assert api.Execution().device.type == "cuda"
    out = {}
    for ex in ("packed", "per_leaf"):
        g = torch.Generator(device=dev).manual_seed(3)
        data, bank, theta0 = mlp_problem(g, S=3, n=64, din=6, hid=9,
                                         dout=2)
        s = api.FSGLD(api.Posterior(mlp_log_lik), data, minibatch=8,
                      step_size=1e-4,
                      surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
                      schedule=api.Schedule(rounds=2, local_steps=5,
                                            n_chains=4,
                                            reassign="permutation"),
                      execution=api.Execution(executor=ex))
        fk.reset_launches()
        out[ex] = s.sample(torch.Generator(device=dev).manual_seed(1),
                           theta0)
        torch.cuda.synchronize()
        if ex == "packed":
            assert fk.LAUNCHES == {"fsgld_update_packed": 10,
                                   "fsgld_update_2d": 0}
        else:
            assert fk.LAUNCHES == {"fsgld_update_packed": 0,
                                   "fsgld_update_2d": 10 * 4}
    for a, b in zip(tu.leaves(out["packed"]), tu.leaves(out["per_leaf"])):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel,federation", [
    ("sghmc", None), ("sgld", "elf-bidir-randk-10%"),
    ("sgld", "straggler-10%"), ("sghmc", "partial-50%")])
def test_sghmc_and_federated_paths_launch_once_per_step(dev, kernel,
                                                        federation):
    """SGHMC and federated rounds on the card: one packed launch per step
    (none for the exchange), the dynamics' own variant, packed ==
    per_leaf bitwise."""
    out = {}
    for ex in ("packed", "per_leaf"):
        g = torch.Generator(device=dev).manual_seed(3)
        data, bank, theta0 = mlp_problem(g, S=3, n=64, din=6, hid=9,
                                         dout=2)
        s = api.FSGLD(api.Posterior(mlp_log_lik), data, minibatch=8,
                      step_size=1e-4, kernel=kernel,
                      surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
                      schedule=api.Schedule(rounds=3, local_steps=5,
                                            n_chains=4),
                      execution=api.Execution(executor=ex),
                      federation=federation)
        fk.reset_launches()
        out[ex] = s.sample(torch.Generator(device=dev).manual_seed(1),
                           theta0)
        torch.cuda.synchronize()
        entry = "fsgld_update_packed" if ex == "packed" else "fsgld_update_2d"
        want = 15 if ex == "packed" else 15 * 4
        assert fk.LAUNCHES[entry] == want
        dyn = "sghmc" if kernel == "sghmc" else "langevin"
        assert fk.DYNAMICS_LAUNCHES[dyn] == want
    for a, b in zip(tu.leaves(out["packed"]), tu.leaves(out["per_leaf"])):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# flash attention, within the kernel's stated tolerance (fa.tolerance)
# ---------------------------------------------------------------------------

# the bf16 kernel's tile edges (128 query rows per CTA; 128-key tiles, 64
# at hd 256), windows smaller and larger than a tile, GQA groups 1, 2, 8
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (True, 300), (False, None)])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 1000, 2048])
@pytest.mark.parametrize("hd", [64, 80, 128, 160, 256])
@pytest.mark.parametrize("H,Hkv", [(2, 2), (4, 2), (8, 1)])
def test_flash_kernel_matches_plain_version(dev, dtype, causal, window, S,
                                            hd, H, Hkv):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(S * hd + H)
    q = torch.randn(2, S, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(2, S, Hkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(2, S, Hkv, hd, generator=g, device=dev).to(dtype)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES["flash_attention"] == 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    assert bool(((out.float() - ref.float()).abs()
                 <= fa.tolerance(ref)).all())


@pytest.mark.parametrize("B,S,H,Hkv,hd,window", [
    (2, 3072, 10, 1, 256, 2048),   # recurrentgemma-2b's 'swa' prefill
    (4, 2048, 32, 8, 128, None),   # phi3.5-moe's 'attn' prefill
    (8, 128, 10, 1, 256, 2048)])   # recurrentgemma-2b at the train shape
def test_flash_kernel_at_the_decoder_families_shapes(dev, B, S, H, Hkv, hd,
                                                     window):
    """A GQA group of 10 (not a power of two), MQA at hd 256 and a window
    that a prompt outruns, as the MoE and hybrid families give the kernel
    (bf16)."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(S + H)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(B, S, Hkv, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, S, Hkv, hd, generator=g, device=dev).bfloat16()
    out = fa.flash_attention(q, k, v, window=window)
    ref = fa.flash_attention_plain(q, k, v, window=window)
    assert bool(((out.float() - ref.float()).abs()
                 <= fa.tolerance(ref)).all())


@pytest.mark.parametrize("hd", [80, 128, 256])
def test_flash_kernel_graph_replay_equals_eager(dev, hd):
    """The tensor maps travel with the launch: a CUDA graph captured over
    the kernel and replayed gives the eager call's output bitwise."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn(2, 1000, 4, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(2, 1000, 2, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(2, 1000, 2, hd, generator=g, device=dev).bfloat16()
    eager = fa.flash_attention(q, k, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fa.flash_attention(q, k, v)
    replayed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)


def test_flash_kernel_refuses_strided_operands(dev):
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(1, 64, 4, 64, device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


def test_serving_prefill_runs_the_kernel_once_per_layer(dev):
    """Smoke qwen3 on the card: prefill launches the kernel once per
    layer and decode never; K=1 serving equals the plain loop bitwise."""
    from repro_torch import models as TM
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.serve import EnsembleServer
    cfg = get_smoke_config("qwen3-1.7b")
    params = TM.serving_params(TM.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    prompt = torch.randint(0, cfg.vocab_size, (2, 100), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    fa.reset_launches()
    logits, cache = TM.prefill_with_cache(params, cfg, prompt, 106)
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    plain, _ = TM.prefill_with_cache(params, cfg, prompt, 106,
                                     attention=flash_attention_plain)
    assert float((logits - plain).abs().max() / plain.abs().max()) < 0.05
    want = [torch.argmax(logits, -1)]
    for t in range(100, 105):
        lg, cache = TM.decode_step(params, cfg, cache, want[-1][:, None],
                                   torch.full((2,), t, device=dev))
        want.append(torch.argmax(lg, -1))
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    srv = EnsembleServer(cfg, draws=tu.tree_map(lambda t: t[None], params),
                         device=dev)
    res = srv.generate(prompt, gen=6)
    assert torch.equal(res.tokens, torch.stack(want, 1))


# ---------------------------------------------------------------------------
# the training path: the differentiable flash entry and one sampling step
# ---------------------------------------------------------------------------

# the train shape of qwen3-1.7b (B 8, S 128, H 16/8, hd 128), a ragged
# multi-tile one with a window, and GQA 8:1
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,hd,window", [
    (8, 128, 16, 8, 128, None), (2, 300, 4, 2, 80, 100),
    (1, 129, 8, 1, 64, None)])
def test_differentiable_flash_matches_plain_autograd(dev, dtype, B, S, H,
                                                     Hkv, hd, window):
    """Forward: one launch, the output within ``fa.tolerance`` of the
    plain scan's and bitwise the serving entry's; the row log-sum-exp
    within 1e-3 of the plain scan's m + log(l) (approximate exp2 in the
    kernel, another order of sums; rows are O(10)). Backward: dq, dk, dv
    within ``fa.tolerance`` of autograd through the plain scan
    ``attention_scan`` on the same values in fp32 (through the bf16 scan
    autograd rounds the probabilities to bf16 before P V, and its dq
    strays 6-10x the tolerance from the exact gradient)."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(S + hd)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    dout = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    pos = torch.arange(S, device=dev).expand(B, S)
    fa.reset_launches()
    out, lse = fa.flash_attention_lse(q, k, v, window=window)
    assert fa.LAUNCHES["flash_attention"] == 1
    assert torch.equal(out, fa.flash_attention(q, k, v, window=window))
    ref, m, l = fa.attention_scan(q, k, v, pos, pos, window=window,
                                  stats=True)
    assert bool(((out.float() - ref.float()).abs()
                 <= fa.tolerance(ref)).all())
    torch.testing.assert_close(lse, m + torch.log(l), atol=1e-3, rtol=0)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launches()
    got = torch.autograd.grad(
        fa.flash_attention_diff(*leaves, window=window), leaves, dout)
    assert fa.LAUNCHES["flash_attention"] == 1
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.attention_scan(*plain, pos, pos, window=window), plain,
        dout.float())
    for a, b in zip(got, want):
        assert a.dtype == dtype
        b = b.to(dtype)
        assert bool(((a.float() - b.float()).abs()
                     <= fa.tolerance(b)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,hd", [
    (8, 1500, 20, 20, 64),    # whisper's encoder at the train shape
    (4, 1500, 20, 20, 64)])   # and in a served request of batch 4
def test_differentiable_flash_non_causal_at_the_encoder_shape(dev, dtype, B,
                                                              S, H, Hkv, hd):
    """The bidirectional self-attention of whisper's encoder (1,500
    frames, 20 heads of 64): the differentiable entry with causal=False,
    one launch, the output and the row log-sum-exp as in
    ``test_differentiable_flash_matches_plain_autograd``, dq, dk, dv
    within ``fa.tolerance`` of fp32 autograd through the plain scan."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(S + B)
    q, k, v, dout = (torch.randn(B, S, n, hd, generator=g, device=dev)
                     .to(dtype) for n in (H, Hkv, Hkv, H))
    pos = torch.arange(S, device=dev).expand(B, S)
    ref, m, l = fa.attention_scan(q, k, v, pos, pos, causal=False,
                                  stats=True)
    out, lse = fa.flash_attention_lse(q, k, v, causal=False)
    assert bool(((out.float() - ref.float()).abs()
                 <= fa.tolerance(ref)).all())
    torch.testing.assert_close(lse, m + torch.log(l), atol=1e-3, rtol=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launches()
    got = torch.autograd.grad(
        fa.flash_attention_diff(*leaves, causal=False), leaves, dout)
    assert fa.LAUNCHES["flash_attention"] == 1
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.attention_scan(*plain, pos, pos, causal=False), plain,
        dout.float())
    for a, b in zip(got, want):
        b = b.to(dtype)
        assert a.dtype == dtype
        assert bool(((a.float() - b.float()).abs()
                     <= fa.tolerance(b)).all())


def test_train_step_launches_the_update_once(dev):
    """qwen3's smoke config on the card, FSGLD with a bf16 'scalar' bank
    on the host: each local step (of 2 chains; of 1 chain, whose second
    step's seeds sit 56 bytes into the round's draw) makes one
    ``fsgld_update_packed`` launch and two flash launches per layer (the
    chains folded into one gradient pass, whose backward re-runs each
    period's forward: ``cfg.remat``); per_leaf gives the same state,
    bitwise."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import token_shards
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params, log_lik_fn
    cfg = get_smoke_config("qwen3-1.7b")
    theta0 = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    data = token_shards(torch.Generator(device=dev).manual_seed(1),
                        num_shards=2, shard_size=4, seq_len=32,
                        vocab_size=cfg.vocab_size)
    ll = lambda p, b: log_lik_fn(p, cfg, b)  # noqa: E731
    bank = api.fit_bank_local_sgld(
        ll, data, theta0, torch.Generator(device=dev).manual_seed(2),
        fit_steps=2, minibatch=2, step_size=1e-5,
        store_dtype=torch.bfloat16)
    for C, T in ((2, 1), (1, 2)):
        out = {}
        for ex in ("packed", "per_leaf"):
            s = api.FSGLD(
                api.Posterior(ll, prior_precision=1.0), data, minibatch=2,
                step_size=1e-5,
                surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
                schedule=api.Schedule(rounds=1, local_steps=T, n_chains=C,
                                      reassign="permutation"),
                execution=api.Execution(executor=ex, collect=False,
                                        bank_device="cpu"))
            fk.reset_launches()
            fa.reset_launches()
            out[ex] = s.sample(torch.Generator(device=dev).manual_seed(3),
                               theta0)
            torch.cuda.synchronize()
            assert cfg.remat and cfg.num_layers % len(cfg.layer_pattern) == 0
            assert fa.LAUNCHES["flash_attention"] == 2 * cfg.num_layers * T
            if ex == "packed":
                assert fk.LAUNCHES == {"fsgld_update_packed": T,
                                       "fsgld_update_2d": 0}
        for a, b in zip(tu.leaves(out["packed"]),
                        tu.leaves(out["per_leaf"])):
            assert torch.isfinite(a).all()
            assert torch.equal(a, b)


def test_full_depth_prefill_unchanged_by_the_statistics_entry(dev):
    """qwen3-1.7b at full width and depth, one draw, 2 x 256 tokens: the
    serving prefill launches the kernel 28 times, and its logits are
    bitwise those of a prefill through the statistics entry (the row
    log-sum-exp written beside changes nothing of the output)."""
    from repro_torch import models as TM
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config("qwen3-1.7b")
    params = TM.serving_params(TM.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    prompt = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    fa.reset_launches()
    logits, _ = TM.prefill_with_cache(params, cfg, prompt, 256)
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers == 28
    with_lse, _ = TM.prefill_with_cache(
        params, cfg, prompt, 256,
        attention=lambda q, k, v, **kw: fa.flash_attention_lse(q, k, v,
                                                               **kw)[0])
    assert torch.equal(logits, with_lse)


def _mlp_sampler(dev, **exe):
    g = torch.Generator(device=dev).manual_seed(3)
    data, bank, theta0 = mlp_problem(g, S=3, n=64, din=6, hid=9, dout=2)
    s = api.FSGLD(api.Posterior(mlp_log_lik), data, minibatch=8,
                  step_size=1e-4,
                  surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
                  schedule=api.Schedule(rounds=4, local_steps=5, n_chains=4,
                                        reassign="permutation"),
                  execution=api.Execution(executor="packed", **exe))
    return s, theta0


def test_quarantine_on_the_packed_kernel_path(dev):
    """Chaos NaN on chain 1 after round 1 under quarantine: word
    [0, 2, 0, 0], the other chains the fault-free run's bitwise, still
    one update launch per step; recovery with the detector on a
    fault-free run is bitwise recovery off."""
    from repro_torch.core.health import Recovery
    from repro_torch.testing import ChaosSpec
    s, theta0 = _mlp_sampler(dev)
    base = s.sample(torch.Generator(device=dev).manual_seed(1), theta0)
    fk.reset_launches()
    out, h = s.engine.run(torch.Generator(device=dev).manual_seed(1),
                          theta0, 4, n_chains=4, reassign="permutation",
                          recovery=Recovery("quarantine"),
                          chaos=ChaosSpec(nan_chains=(1,), nan_rounds=(1,)))
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fsgld_update_packed"] == 20
    assert h.word.tolist() == [0, 2, 0, 0]
    for a, b in zip(tu.leaves(base), tu.leaves(out)):
        assert torch.equal(a[[0, 2, 3]], b[[0, 2, 3]])
        assert torch.isfinite(b).all()
    clean, h2 = s.engine.run(torch.Generator(device=dev).manual_seed(1),
                             theta0, 4, n_chains=4, reassign="permutation",
                             recovery=Recovery("respawn",
                                               divergence_threshold=1e6))
    assert h2.n_healthy == 4
    assert all(torch.equal(a, b) for a, b in zip(tu.leaves(base),
                                                 tu.leaves(clean)))


def test_resume_on_the_packed_kernel_path(dev, tmp_path):
    """Snapshots every round, the newest deleted, resume: the card's
    generator state rides the snapshot and the trace is bitwise the
    uninterrupted run's."""
    import shutil
    from repro_torch.checkpoint import list_snapshots
    s, theta0 = _mlp_sampler(dev)
    ref = s.sample(torch.Generator(device=dev).manual_seed(1), theta0)
    snaps = str(tmp_path / "snaps")
    kw = dict(snapshot_every=1, snapshot_path=snaps)
    _mlp_sampler(dev, **kw)[0].sample(
        torch.Generator(device=dev).manual_seed(1), theta0)
    shutil.rmtree(list_snapshots(snaps)[-1][1])
    out = _mlp_sampler(dev, resume=True, **kw)[0].sample(
        torch.Generator(device=dev).manual_seed(1), theta0)
    assert all(torch.equal(a, b) for a, b in zip(tu.leaves(ref),
                                                 tu.leaves(out)))


def test_bf16_leaf_saves_and_restores_from_the_card(dev, tmp_path):
    from repro_torch import checkpoint
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn(300, 7, generator=g, device=dev),
            "b": torch.randn(5, generator=g, device=dev).to(torch.bfloat16)}
    checkpoint.save(str(tmp_path / "ck"), tree)
    got, _, _ = checkpoint.restore(str(tmp_path / "ck"), tree)
    for k in tree:
        assert got[k].device.type == "cpu" and got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], tree[k].cpu())


@pytest.mark.parametrize("executor", ["packed", "per_leaf"])
def test_telemetry_on_the_card_is_bitwise_off(dev, executor):
    """Telemetry's rows on the card: the run bitwise the run without it,
    still one update launch per step (per leaf), every row finite."""
    import numpy as np
    from repro_torch.obs import Telemetry
    s, theta0 = _mlp_sampler(dev)
    s.execution = api.Execution(device=dev, executor=executor)
    s._engine = None
    base = s.sample(torch.Generator(device=dev).manual_seed(1), theta0)
    fk.reset_launches()
    out, frame = s.sample(torch.Generator(device=dev).manual_seed(1),
                          theta0, telemetry=Telemetry(log_every=2))
    torch.cuda.synchronize()
    L = len(tu.leaves(theta0))
    assert dict(fk.LAUNCHES) == (
        {"fsgld_update_packed": 20, "fsgld_update_2d": 0}
        if executor == "packed" else
        {"fsgld_update_packed": 0, "fsgld_update_2d": 20 * L})
    assert all(torch.equal(a, b) for a, b in zip(tu.leaves(base),
                                                 tu.leaves(out)))
    assert frame.rounds == 4 and all(np.isfinite(a).all()
                                     for a in frame.metrics.values())


@pytest.mark.parametrize("prefetch", [True, False])
def test_streamed_windows_on_a_side_stream_are_bitwise(dev, prefetch):
    """The streamed path on the card: a lazy client source (rows built on
    the host, copied from pinned buffers on a side stream) and a resident
    stack (gathered on the side stream), each bitwise its resident run."""
    from repro_torch.fed import Stream, SyntheticClientSource
    src = SyntheticClientSource(5, num_clients=40, shard_size=16, seq_len=8,
                                vocab_size=64)

    def tok_ll(theta, batch):
        return torch.sum(torch.log_softmax(theta, -1)[batch["labels"]])

    def build(data, stream):
        return api.FSGLD(
            api.Posterior(tok_ll), data, minibatch=4, step_size=1e-3,
            method="dsgld", surrogate=api.SurrogateSpec(kind="none"),
            schedule=api.Schedule(rounds=6, local_steps=3, n_chains=5,
                                  reassign="permutation"),
            execution=api.Execution(device=dev, executor="packed",
                                    collect=False, stream=stream))

    stacked = {k: torch.as_tensor(v).to(dev)
               for k, v in src.rows(range(40)).items()}
    theta0 = torch.zeros(64, device=dev)
    stream = Stream(resident=10, window=2, prefetch=prefetch)
    for data in (src, stacked):
        ref = build(data, None).sample(
            torch.Generator(device=dev).manual_seed(2), theta0)
        fk.reset_launches()
        got = build(data, stream).sample(
            torch.Generator(device=dev).manual_seed(2), theta0)
        torch.cuda.synchronize()
        assert fk.LAUNCHES["fsgld_update_packed"] == 18
        assert torch.equal(ref, got)


# ---------------------------------------------------------------------------
# the custom ops (torch.library) and the pipeline's side-stream copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 64])
def test_flash_custom_ops_equal_the_plain_version_and_their_fakes(dev,
                                                                  window):
    """``repro_torch::flash_attention`` and ``::flash_attention_lse`` on
    the card against the plain version (the kernel's tolerance), and the
    shape functions' outputs against the real ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 300, 4, 64), generator=g, device=dev,
                           dtype=torch.bfloat16)[:, :, :h]
               .contiguous() for h in (4, 2, 2))
    want, m, l = fa._plain_stats(q, k, v, None, None, True, window,
                                 fa.BLOCK_K)
    out = torch.ops.repro_torch.flash_attention(q, k, v, True, window or 0)
    out2, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, True,
                                                          window or 0)
    for o in (out, out2):
        assert bool(((o.float() - want.float()).abs()
                     <= fa.tolerance(want)).all())
    torch.testing.assert_close(lse, m + torch.log(l), atol=1e-3, rtol=0)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fk_, fv = (mode.from_tensor(t) for t in (q, k, v))
        fo, fl = torch.ops.repro_torch.flash_attention_lse(fq, fk_, fv,
                                                           True, 0)
    assert (fo.shape, fo.dtype) == (out2.shape, out2.dtype)
    assert (fl.shape, fl.dtype) == (lse.shape, lse.dtype)


@pytest.mark.parametrize("variant", ["plain", "scalar", "diag"])
def test_update_custom_ops_equal_the_plain_version_and_their_fakes(dev,
                                                                   variant):
    """``repro_torch::fsgld_update_2d`` (with and without a shard's segment
    table) and ``::fsgld_update_packed`` on the card against the plain
    version, and the shape function against the real output."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rows, C = 64, 2
    th, g, seeds, sc, kw = _operands(dev, C * rows, rows, variant,
                                     "langevin", 1, C)
    seeds, sc = seeds[:, 0], sc[:, 0]
    want = fk.fsgld_update_2d_plain(th, g, seeds, sc, variant=variant,
                                    dynamics="langevin", chains=C, **kw)
    got = fk.fsgld_update_2d(th, g, seeds, sc, variant=variant, chains=C,
                             block_rows=8, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    base = (torch.arange(rows // 8, device=dev, dtype=torch.int32) * 1024
            + 4096)
    want = fk.fsgld_update_2d_plain(th, g, seeds, sc, variant=variant,
                                    dynamics="langevin", chains=C,
                                    seg_base=base, block_rows=8, **kw)
    got = fk.fsgld_update_2d(th, g, seeds, sc, variant=variant, chains=C,
                             block_rows=8, seg_base=base, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fo = fk.fsgld_update_2d(mode.from_tensor(th), mode.from_tensor(g),
                                seeds, sc, variant=variant, chains=C,
                                block_rows=8, **{k: mode.from_tensor(v)
                                                 for k, v in kw.items()})
    assert (fo.shape, fo.dtype) == (got.shape, got.dtype)


def test_pipeline_side_stream_copy_equals_a_blocking_copy(dev):
    """``FederatedPipeline`` on the card (pinned host rows copied on a
    side stream, the consumer waiting on the copy's event) gives the
    batches of a blocking copy of the same rows, in order."""
    import numpy as np

    from repro_torch.data.pipeline import (ClientDataset, FederatedPipeline,
                                           categorical_schedule)

    def clients():
        return [ClientDataset({"tokens": np.arange(64 * 256).reshape(64, 256)
                               + 10**6 * c}, seed=c) for c in range(3)]
    pipe = FederatedPipeline(clients(), 16, categorical_schedule(
        [0.5, 0.25, 0.25], seed=4), prefetch=3, device=dev)
    ref = clients()
    sched = categorical_schedule([0.5, 0.25, 0.25], seed=4)
    for _ in range(12):
        s, batch = next(pipe)
        t = batch["tokens"] * 1          # used on the consumer's stream
        want_s = next(sched)
        want = torch.from_numpy(ref[want_s].next_batch(16)["tokens"]).to(dev)
        assert s == want_s and torch.equal(t, want)
