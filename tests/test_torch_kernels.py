"""The port's fused-update kernel module against the JAX package's.

Same numpy inputs on both sides; the Pallas kernels run in interpret mode
(``interpret=True``). On the CPU the port's wrappers take the kernel's
plain PyTorch version, which is what is held here; the CUDA kernel is held
against that plain version on the card (``chip_smoke.py``).

Tolerances: the hash and the uniforms u1/u2 are integer / exactly-rounded
float32 work and must agree bitwise. ``log``, ``cos`` and ``sqrt`` differ
between XLA-CPU and torch in the last ulps, so the normals are held to
1e-6 and updated parameters (O(1) values) to 1e-5 absolute + relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fsgld_update as jk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import fsgld_update as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

CELLS = [(v, d) for v in ("plain", "scalar", "diag")
         for d in ("langevin", "sghmc")]
SEEDS = [0, 7, 12345, 2**31 - 2]


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_and_uniforms_bitwise(seed):
    idx = np.arange(1 << 16, dtype=np.uint32) * np.uint32(40503)
    jh = np.asarray(jref.mix(jnp.asarray(idx)))
    th = tref.mix(torch.from_numpy(idx.astype(np.int64))).numpy()
    np.testing.assert_array_equal(jh.astype(np.int64), th)

    # the reference's uniforms, spelled out from its own mix
    s, i = jnp.uint32(seed), jnp.asarray(idx)
    h1 = jref.mix(i * jnp.uint32(2) + jnp.uint32(1)
                  + s * jnp.uint32(0x9E3779B9))
    h2 = jref.mix(i * jnp.uint32(2) + s * jnp.uint32(0x85EBCA77))
    ju1 = (h1 >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24)) \
        + (0.5 / (1 << 24))
    ju2 = (h2 >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24))
    tu1, tu2 = tref.uniforms(torch.tensor(seed),
                             torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(ju1), tu1.numpy())
    np.testing.assert_array_equal(np.asarray(ju2), tu2.numpy())

    jn = np.asarray(jref.gaussian_noise(s, i))
    tn = tref.gaussian_noise(torch.tensor(seed),
                             torch.from_numpy(idx.astype(np.int64))).numpy()
    np.testing.assert_allclose(tn, jn, atol=1e-6, rtol=0)


@pytest.mark.parametrize("threads", [2, 4, 8])
def test_noise_does_not_depend_on_thread_count(threads):
    """The plain normals are the same whichever thread (and vectorised
    float32 ``log``) computes an element's chunk: one thread vs many,
    bitwise."""
    idx = torch.from_numpy(
        (np.arange(1 << 16, dtype=np.uint32) * np.uint32(40503))
        .astype(np.int64))
    seed = torch.tensor(12345)
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = tref.gaussian_noise(seed, idx)
        torch.set_num_threads(threads)
        many = tref.gaussian_noise(seed, idx)
    finally:
        torch.set_num_threads(before)
    assert one.dtype == torch.float32
    assert torch.equal(one, many)


def test_ref_flat_update_matches():
    rng = np.random.default_rng(0)
    P = 3001
    th, g, mg, ms = (rng.standard_normal(P).astype(np.float32)
                     for _ in range(4))
    lg, ls = (np.abs(rng.standard_normal(P)).astype(np.float32) + 0.1
              for _ in range(2))
    kw = dict(h=1e-3, scale=37.0, f_s=0.1, prior_prec=1.0, alpha=1.0,
              temperature=1.0)
    a = jref.fsgld_update_flat(jnp.asarray(th), jnp.asarray(g),
                               jnp.uint32(99), mu_g=jnp.asarray(mg),
                               mu_s=jnp.asarray(ms), lam_g=jnp.asarray(lg),
                               lam_s=jnp.asarray(ls), **kw)
    b = tref.fsgld_update_flat(*(torch.from_numpy(x) for x in (th, g)),
                               torch.tensor(99),
                               mu_g=torch.from_numpy(mg),
                               mu_s=torch.from_numpy(ms),
                               lam_g=torch.from_numpy(lg),
                               lam_s=torch.from_numpy(ls), **kw)
    _close(b.numpy(), a)


def _operands(rng, rows, rows_shared):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"th": f(rows, 128), "g": f(rows, 128), "ms": f(rows, 128),
            "ls": np.abs(f(rows, 128)) + 0.1, "r": f(rows, 128),
            "mg": f(rows_shared, 128), "lg": np.abs(f(rows_shared, 128))
            + 0.1}


def _variant_kw(o, variant, dynamics):
    kw = {}
    if variant != "plain":
        kw.update(mu_g=o["mg"], mu_s=o["ms"])
    if variant == "diag":
        kw.update(lam_g=o["lg"], lam_s=o["ls"])
    if dynamics == "sghmc":
        kw["r2d"] = o["r"]
    return kw


def _pair(out):
    return out if isinstance(out, tuple) else (out,)


RAGGED = {"a": np.zeros(1500, np.float32), "b": np.zeros((7, 11), np.float32),
          "c": np.zeros(2100, np.float32)}


@pytest.mark.parametrize("variant,dynamics", CELLS)
def test_packed_plain_matches_pallas(variant, dynamics):
    """3-leaf ragged layout, C = 3: every (chain, leaf) has its own seed
    and scalar row, and the noise index restarts in every leaf."""
    rng = np.random.default_rng(1)
    jl = jops.make_packed_layout(jax.tree.map(jnp.asarray, RAGGED))
    tl = tops.make_packed_layout(
        {k: torch.from_numpy(v) for k, v in RAGGED.items()})
    C, L = 3, tl.num_leaves
    o = _operands(rng, C * tl.rows_total, tl.rows_total)
    seeds = rng.integers(0, 2**31 - 1, (C, L)).astype(np.uint32)
    sc = (np.abs(rng.standard_normal((C, L, 9))) * 0.1 + 0.05
          ).astype(np.float32)
    kw = _variant_kw(o, variant, dynamics)
    a = jk.fsgld_update_packed(
        jnp.asarray(o["th"]), jnp.asarray(o["g"]), jnp.asarray(seeds),
        jnp.asarray(sc), variant=variant, dynamics=dynamics,
        seg_leaf=jl.seg_leaf, seg_base=jl.seg_base, chains=C,
        interpret=True, **{k: jnp.asarray(v) for k, v in kw.items()})
    seg_leaf, seg_base = tl.tables("cpu")
    # the entry updates theta (and r) in place: give it copies
    b = tk.fsgld_update_packed(
        torch.tensor(o["th"]), torch.from_numpy(o["g"]),
        torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(sc),
        variant=variant, dynamics=dynamics, seg_leaf=seg_leaf,
        seg_base=seg_base, chains=C,
        **{k: torch.tensor(v) for k, v in kw.items()})
    for x, y in zip(_pair(a), _pair(b)):
        _close(y.numpy(), x)


@pytest.mark.parametrize("variant,dynamics", CELLS)
def test_packed_entry_updates_its_inputs_in_place(variant, dynamics):
    """The packed entry returns theta2d (and r2d) themselves, holding its
    plain version's result on the same operands, bitwise; g and the
    surrogate operands are left as they were."""
    rng = np.random.default_rng(3)
    tl = tops.make_packed_layout(
        {k: torch.from_numpy(v) for k, v in RAGGED.items()})
    C, L = 2, tl.num_leaves
    o = _operands(rng, C * tl.rows_total, tl.rows_total)
    seeds = torch.from_numpy(rng.integers(0, 2**31 - 1, (C, L)))
    sc = torch.from_numpy((np.abs(rng.standard_normal((C, L, 9))) * 0.1
                           + 0.05).astype(np.float32))
    seg_leaf, seg_base = tl.tables("cpu")
    kw = {k: torch.from_numpy(v)
          for k, v in _variant_kw(o, variant, dynamics).items()}
    kw.update(variant=variant, dynamics=dynamics, seg_leaf=seg_leaf,
              seg_base=seg_base, chains=C, block_rows=tl.block_rows)
    th, g = torch.from_numpy(o["th"]), torch.from_numpy(o["g"])
    want = _pair(tk.fsgld_update_packed_plain(th, g, seeds, sc, **kw))
    keep = {k: v.clone() for k, v in kw.items()
            if isinstance(v, torch.Tensor) and k != "r2d"}
    got = _pair(tk.fsgld_update_packed(th, g, seeds, sc, **kw))
    assert got[0] is th and (dynamics == "langevin" or got[1] is kw["r2d"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for k, v in keep.items():
        assert torch.equal(kw[k], v)


@pytest.mark.parametrize("variant,dynamics", CELLS)
def test_2d_plain_matches_pallas_chain_batched(variant, dynamics):
    rng = np.random.default_rng(2)
    C, rows_c, br = 3, 16, 8
    o = _operands(rng, C * rows_c, rows_c)
    seeds = rng.integers(0, 2**31 - 1, (C,)).astype(np.uint32)
    sc = (np.abs(rng.standard_normal((C, 9))) * 0.1 + 0.05
          ).astype(np.float32)
    kw = _variant_kw(o, variant, dynamics)
    a = jk.fsgld_update_2d(
        jnp.asarray(o["th"]), jnp.asarray(o["g"]), jnp.asarray(seeds),
        jnp.asarray(sc), variant=variant, dynamics=dynamics, chains=C,
        block_rows=br, interpret=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    b = tk.fsgld_update_2d(
        torch.from_numpy(o["th"]), torch.from_numpy(o["g"]),
        torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(sc),
        variant=variant, dynamics=dynamics, chains=C, block_rows=br,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    for x, y in zip(_pair(a), _pair(b)):
        _close(y.numpy(), x)


def test_wrappers_refuse_other_devices_and_count_no_plain_launch():
    """A tensor on neither the CPU nor CUDA raises — there is no quiet
    path — and the plain version never counts as a kernel launch."""
    tk.reset_launches()
    meta = dict(device="meta", dtype=torch.float32)
    th = torch.empty(16, 128, **meta)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tk.fsgld_update_2d(th, th, torch.zeros(2, dtype=torch.int64,
                                                device="meta"),
                           torch.empty(2, 9, **meta), chains=2)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tk.fsgld_update_packed(
            th, th, torch.zeros(2, 1, dtype=torch.int64, device="meta"),
            torch.empty(2, 1, 9, **meta), seg_leaf=(0,), seg_base=(0,),
            chains=2)
    x = torch.zeros(16, 128)
    tk.fsgld_update_2d(x, x, torch.zeros(2, dtype=torch.int64),
                       torch.zeros(2, 9), chains=2)
    assert tk.LAUNCHES == {"fsgld_update_packed": 0, "fsgld_update_2d": 0}


def test_wrapper_checks_shapes():
    x = torch.zeros(16, 128)
    with pytest.raises(ValueError, match="mu_g"):
        tk.fsgld_update_2d(x, x, torch.zeros(2, dtype=torch.int64),
                           torch.zeros(2, 9), variant="diag", chains=2)
    with pytest.raises(ValueError, match="rows"):
        tk.fsgld_update_packed(x, x, torch.zeros(2, 1, dtype=torch.int64),
                               torch.zeros(2, 1, 9), seg_leaf=(0,),
                               seg_base=(0,), chains=3)


def test_nvcc_command_targets_hopper_without_fast_math():
    assert set(_build.SOURCES) == {"fsgld_update", "flash_attention"}
    for name, src in _build.SOURCES.items():
        cmd = _build.nvcc_command("nvcc", src, _build.library_path(name))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast_math" in c or "fast-math" in c for c in cmd)
        assert src.exists()
        assert name in _build.library_path(name).name
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


def test_build_times_each_source_and_reports_a_failure(tmp_path,
                                                       monkeypatch):
    """``build`` runs one compiler per missing library, records each
    one's seconds, installs what compiled and names what did not."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "for a; do case $a in *flash_attention.cu) "
                    "echo 'error: planted' >&2; exit 3;; esac; done\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && "
                    "touch \"$2\"; shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    seconds = {}
    out = _build.build("fsgld_update", seconds=seconds)
    assert out["fsgld_update"].exists()
    assert seconds["fsgld_update"] >= 0
    with pytest.raises(RuntimeError, match="planted"):
        _build.build(seconds=seconds)
    assert set(seconds) == {"fsgld_update", "flash_attention"}
    assert not _build.library_path("flash_attention").exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        out["fsgld_update"].name]


def test_build_removes_its_temporary_files_when_nvcc_cannot_start(
        tmp_path, monkeypatch):
    """A compiler that cannot be started raises out of ``build``, and the
    temporary libraries it was to write are gone from the build
    directory."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(tmp_path / "none"))
    with pytest.raises(OSError):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []
