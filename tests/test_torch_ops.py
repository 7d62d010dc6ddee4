"""The port's kernel wrappers and packed layout against the JAX package's
(``repro.kernels.ops``), and packed == per-leaf inside the port.

Layout tables are integers and must be equal exactly; packing moves
values without arithmetic and must round-trip bitwise. Updated parameters
are held to 1e-5 (the normals differ from XLA-CPU's by <= 1e-6, see
test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import tree as tu
from repro_torch.core.surrogate import make_bank
from repro_torch.kernels import ops as tops
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

TREE = {"w1": np.zeros((9, 33), np.float32), "b1": np.zeros(33, np.float32),
        "blk": {"w2": np.zeros((33, 5), np.float32),
                "z": np.zeros(1, np.float32)},
        "big": np.zeros(3000, np.float32)}


def _t(tree):
    return tu.tree_map(torch.from_numpy, tree)


def test_tree_walks_free_their_leaves_without_the_cyclic_collector():
    """flatten/unflatten/tree_map hold no reference cycle: a leaf dropped
    by its owner is freed at once (at full width such a cycle kept ~40 GB
    of fp32 draws alive on the card)."""
    import gc
    import weakref
    t = torch.zeros(4)
    ref = weakref.ref(t)
    gc.disable()
    try:
        tree = {"a": {"b": t}, "c": [None, (t,)]}
        leaves, treedef = tu.flatten(tree)
        assert tu.unflatten(treedef, leaves)["a"]["b"] is t
        out = tu.tree_map(lambda x, y: x + y, tree, tree)
        assert torch.equal(tu.leaves(out)[0], torch.zeros(4))
        del t, tree, leaves
        assert ref() is None
    finally:
        gc.enable()


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _chains(rng, tree, C):
    return tu.tree_map(
        lambda a: rng.standard_normal((C,) + a.shape).astype(np.float32),
        tree)


@pytest.mark.parametrize("block_rows", [8, 16])
def test_layout_tables_equal_jax(block_rows):
    jl = jops.make_packed_layout(_j(TREE), block_rows=block_rows)
    tl = tops.make_packed_layout(_t(TREE), block_rows=block_rows)
    for f in ("shapes", "sizes", "rows", "row_offsets", "rows_total",
              "block_rows", "seg_leaf", "seg_base"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.bpc == jl.bpc and tl.num_leaves == jl.num_leaves
    sl, sb = tl.tables("cpu")
    assert sl.dtype == torch.int32 and tuple(sl.tolist()) == jl.seg_leaf
    assert tuple(sb.tolist()) == jl.seg_base
    assert tl.tables("cpu")[0] is sl  # uploaded once per device


def test_pack_matches_jax_and_round_trips():
    rng = np.random.default_rng(0)
    C = 3
    ch = _chains(rng, TREE, C)
    jl = jops.make_packed_layout(_j(TREE))
    tl = tops.make_packed_layout(_t(TREE))
    jbuf = np.asarray(jl.pack(_j(ch)))
    tbuf = tl.pack(_t(ch))
    np.testing.assert_array_equal(tbuf.numpy(), jbuf)
    back = tl.unpack(tbuf)
    for a, b in zip(tu.leaves(back), tu.leaves(_t(ch))):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        tl.pack_shared(_t(tu.tree_map(lambda a: a[0], ch))).numpy(),
        np.asarray(jl.pack_shared(_j(tu.tree_map(lambda a: a[0], ch)))))


def test_pack_into_buffer_in_place():
    rng = np.random.default_rng(1)
    tl = tops.make_packed_layout(_t(TREE))
    buf = torch.zeros(2 * tl.rows_total, 128)
    ptr = buf.data_ptr()
    out = tl.pack(_t(_chains(rng, TREE, 2)), out=buf)
    assert out is buf and buf.data_ptr() == ptr
    ch = _chains(rng, TREE, 2)
    tl.pack(_t(ch), out=buf)
    assert torch.equal(buf, tl.pack(_t(ch)))  # pad stayed zero


def test_quantize_matches_jax_for_bf16_leaf():
    rng = np.random.default_rng(2)
    tree = {"a": np.zeros((5, 40), np.float32),
            "h": np.zeros(300, np.float32)}
    jt = {"a": jnp.zeros((5, 40), jnp.float32),
          "h": jnp.zeros(300, jnp.bfloat16)}
    tt = {"a": torch.zeros(5, 40), "h": torch.zeros(300,
                                                    dtype=torch.bfloat16)}
    jl = jops.make_packed_layout(jt)
    tl = tops.make_packed_layout(tt)
    assert not tl.all_fp32
    buf = rng.standard_normal((2 * tl.rows_total, 128)).astype(np.float32)
    q_j = np.asarray(jl.quantize(jnp.asarray(buf)))
    q_t = tl.quantize(torch.from_numpy(buf.copy()))
    np.testing.assert_array_equal(q_t.numpy(), q_j)
    assert torch.equal(tl.quantize(q_t.clone()), q_t)  # a fixed point
    f32 = tops.make_packed_layout(_t(tree))
    x = torch.from_numpy(buf.copy())
    assert f32.quantize(x) is x


def test_scalar_rows_equal_jax():
    rng = np.random.default_rng(3)
    C = 4
    tl = tops.make_packed_layout(_t(TREE))
    jl = jops.make_packed_layout(_j(TREE))
    L = tl.num_leaves
    scale = rng.uniform(1, 100, C).astype(np.float32)
    f_s = rng.uniform(0.1, 0.5, C).astype(np.float32)
    lg = rng.uniform(0.5, 2, L).astype(np.float32)
    ls = rng.uniform(0.5, 2, (C, L)).astype(np.float32)
    kw = dict(h=1e-3, prior_prec=1.0, alpha=0.7, temperature=0.9,
              friction=0.1)
    a = jops.packed_scalar_rows(jl, scale=jnp.asarray(scale),
                                f_s=jnp.asarray(f_s),
                                lam_g_leaf=jnp.asarray(lg),
                                lam_s_leaf=jnp.asarray(ls), **kw)
    b = tops.packed_scalar_rows(tl, scale=torch.from_numpy(scale),
                                f_s=torch.from_numpy(f_s),
                                lam_g_leaf=torch.from_numpy(lg),
                                lam_s_leaf=torch.from_numpy(ls), **kw)
    assert b.shape == (C, L, 9)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    a0 = jops.packed_scalar_rows(jl, scale=jnp.asarray(scale),
                                 f_s=jnp.asarray(f_s), **kw)
    b0 = tops.packed_scalar_rows(tl, scale=torch.from_numpy(scale),
                                 f_s=torch.from_numpy(f_s), **kw)
    np.testing.assert_array_equal(b0.numpy(), np.asarray(a0))


@pytest.mark.parametrize("variant", ["plain", "scalar", "diag"])
def test_fused_update_flat_matches_jax(variant):
    rng = np.random.default_rng(4)
    P = 1000
    th, g, mg, ms = (rng.standard_normal(P).astype(np.float32)
                     for _ in range(4))
    lg, ls = (np.abs(rng.standard_normal(P)).astype(np.float32) + 0.1
              for _ in range(2))
    kw = dict(h=1e-3, scale=37.0, f_s=0.1, prior_prec=1.0, alpha=1.0,
              temperature=1.0, block_rows=8)
    sur = {"plain": {}, "scalar": dict(mu_g=mg, mu_s=ms, lam_g=0.7,
                                       lam_s=0.3),
           "diag": dict(mu_g=mg, mu_s=ms, lam_g=lg, lam_s=ls)}[variant]
    conv = lambda f: {k: (f(v) if isinstance(v, np.ndarray)  # noqa: E731
                          else v) for k, v in sur.items()}
    a = jops.fused_update_flat(jnp.asarray(th), jnp.asarray(g),
                               jnp.uint32(99), interpret=True,
                               **conv(jnp.asarray), **kw)
    b = tops.fused_update_flat(torch.from_numpy(th), torch.from_numpy(g),
                               99, **conv(torch.from_numpy), **kw)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("variant", ["plain", "scalar", "diag"])
def test_fused_update_chains_flat_matches_jax(variant):
    rng = np.random.default_rng(5)
    C, P = 3, 700
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    th, g, ms, mg = f(C, P), f(C, P), f(C, P), f(P)
    ls, lg = np.abs(f(C, P)) + 0.1, np.abs(f(P)) + 0.1
    seeds = rng.integers(0, 2**31 - 1, C).astype(np.uint32)
    scale = rng.uniform(1, 50, C).astype(np.float32)
    f_s = rng.uniform(0.1, 0.5, C).astype(np.float32)
    sur = {"plain": {},
           "scalar": dict(mu_g=mg, mu_s=ms, lam_g=np.float32(0.7),
                          lam_s=rng.uniform(0.2, 1, C).astype(np.float32)),
           "diag": dict(mu_g=mg, mu_s=ms, lam_g=lg, lam_s=ls)}[variant]
    kw = dict(h=1e-3, prior_prec=1.0, alpha=1.0, temperature=1.0,
              block_rows=8)
    a = jops.fused_update_chains_flat(
        jnp.asarray(th), jnp.asarray(g), jnp.asarray(seeds),
        scale=jnp.asarray(scale), f_s=jnp.asarray(f_s), interpret=True,
        **{k: jnp.asarray(v) for k, v in sur.items()}, **kw)
    b = tops.fused_update_chains_flat(
        torch.from_numpy(th), torch.from_numpy(g),
        torch.from_numpy(seeds.astype(np.int64)),
        scale=torch.from_numpy(scale), f_s=torch.from_numpy(f_s),
        **{k: torch.as_tensor(v) for k, v in sur.items()}, **kw)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", [None, "scalar", "diag"])
def test_packed_step_equals_per_leaf_bitwise(kind):
    """One packed launch over all leaves == one per-leaf launch per leaf,
    bitwise, on the same (C, L) seeds."""
    rng = np.random.default_rng(6)
    C, S = 3, 4
    tree = TREE if kind != "diag" else {"v": np.zeros(2500, np.float32)}
    th = _t(_chains(rng, tree, C))
    g = _t(_chains(rng, tree, C))
    layout = tops.make_packed_layout(tu.tree_map(lambda t: t[0], th))
    L = layout.num_leaves
    sids = torch.tensor([2, 0, 2])
    seeds = torch.from_numpy(rng.integers(0, 2**31 - 1, (C, L)))
    scale = torch.tensor([30.0, 12.0, 30.0])
    f_s = torch.tensor([0.25, 0.25, 0.25])
    hyper = dict(h=1e-3, prior_prec=1.0, alpha=1.0, temperature=1.0)
    bank = None
    ops_kw, lam = {}, {}
    if kind == "scalar":
        bank = make_bank(_t(_chains(rng, tree, S)),
                         tu.tree_map(lambda a: torch.from_numpy(
                             rng.uniform(0.5, 2, S).astype(np.float32)),
                             tree), "scalar")
        means_p = layout.pack(bank.means).reshape(S, -1, 128)
        ops_kw = {"mu_g": layout.pack_shared(bank.global_.mean),
                  "mu_s": means_p[sids].reshape(-1, 128)}
        lam = dict(lam_g_leaf=torch.stack(tu.leaves(bank.global_.prec)),
                   lam_s_leaf=torch.stack(tu.leaves(bank.precs), 1)[sids])
    elif kind == "diag":
        P = 2500
        bank = make_bank(torch.from_numpy(rng.standard_normal(
            (S, P)).astype(np.float32)), torch.from_numpy(rng.uniform(
                0.5, 2, (S, P)).astype(np.float32)), "diag")
        shared = lambda v: layout.pack_shared({"v": v})  # noqa: E731
        ops_kw = {"mu_g": shared(bank.global_.mean),
                  "lam_g": shared(bank.global_.prec),
                  "mu_s": layout.pack({"v": bank.means[sids]}),
                  "lam_s": layout.pack({"v": bank.precs[sids]})}
    variant = kind or "plain"
    scalars = tops.packed_scalar_rows(layout, scale=scale, f_s=f_s, **lam,
                                      **hyper)
    out = layout.unpack(tops.packed_step(
        layout, layout.pack(th), layout.pack(g), seeds, scalars,
        variant=variant, **ops_kw))
    ref = tops.fused_update_chains_tree(
        th, g, seeds, scale=scale, f_s=f_s, bank=bank, sids=sids,
        surrogate_kind=kind, **hyper)
    for a, b in zip(tu.leaves(out), tu.leaves(ref)):
        assert torch.equal(a, b)
