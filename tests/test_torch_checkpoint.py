"""The port's checkpoints and draw banks (``repro_torch.checkpoint``),
its ensemble server's ``bank=`` / ``refresh()`` and ``repro_torch.obs``
against the JAX package's.

* Interop both ways: a bank the JAX package writes (fp32 and bf16
  leaves) is read by the port into the same arrays, bit for bit, under
  the same fingerprint; one the port writes is read by the JAX package.
  The same arrays give the same ``arrays.npz`` and ``manifest.json``
  BYTES from either package.
* The refusal contract (another arch's bank) and the degradation
  contract (corrupt draws skipped, older ones backfill, a wholly corrupt
  bank refused) of ``test_chaos.py:349-436``.
* The server: the initial load raises, a live server keeps its ensemble
  through a failed refresh, flaky reads are retried with backoff,
  refresh hot-swaps fresh draws.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_smoke_config as jsmoke
from repro.models import init_params as jinit
from repro_torch import api, checkpoint, obs
from repro_torch import tree as tu
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serve import EnsembleServer
from repro_torch.serve.server import skeleton
from repro_torch.testing import corrupt_draw, flaky_io, truncate_file
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)

ARCH = "h2o-danube-1.8b"


def _numpy_tree(seed=0):
    """A tree with fp32, bf16 and int32 leaves, nested dict and tuple."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 5)).astype(np.float32),
            "blocks": ({"a": rng.normal(size=(7,)).astype(np.float32)},
                       {"a": rng.normal(size=(2, 2)).astype(np.float32)}),
            "emb": rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16),
            "ids": rng.integers(0, 9, size=(5,)).astype(np.int32)}


def _to_torch(tree):
    def one(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return jax.tree.map(one, tree)


def _bits(x):
    """Raw bytes of a numpy/jax array or a torch tensor (bf16 too)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _meta(arch, r=0, dtype="float32"):
    return dict(method="fsgld", round=r, scenario="identity", seed=0,
                dtype=dtype, arch=arch)


# ---------------------------------------------------------------------------
# interop with the JAX package, both ways
# ---------------------------------------------------------------------------

def test_names_and_fingerprint_equal_the_jax_packages():
    tree = _numpy_tree()
    mine = _to_torch(tree)
    assert [n for n, _ in tu.leaves_with_names(mine)] == [
        "blocks/0/a", "blocks/1/a", "emb", "ids", "w"]
    assert checkpoint.tree_fingerprint(mine) == jckpt.tree_fingerprint(tree)
    meta = tu.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device="meta"), mine)
    assert checkpoint.tree_fingerprint(meta) == jckpt.tree_fingerprint(tree)
    assert checkpoint.dtype_name(torch.bfloat16) == "bfloat16"
    assert checkpoint.dtype_name(np.dtype(np.int32)) == "int32"


def test_the_same_arrays_give_the_same_bytes(tmp_path):
    """``save`` of one tree by each package: identical arrays.npz and
    manifest.json, byte for byte (np.savez's layout, bf16 as '<V2')."""
    tree = _numpy_tree()
    meta = _meta("x", r=3)
    jckpt.save(str(tmp_path / "j"), tree, step=3, extra={"k": 1},
               meta=jckpt.DrawMeta(**meta))
    checkpoint.save(str(tmp_path / "t"), _to_torch(tree), step=3,
                    extra={"k": 1}, meta=checkpoint.DrawMeta(**meta))
    for f in ("arrays.npz", "manifest.json"):
        with open(tmp_path / "j" / f, "rb") as a, \
                open(tmp_path / "t" / f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_jax_bank_reads_into_the_ports_arrays(tmp_path, dtype):
    """A bank of qwen3's smoke parameters written by
    ``repro.checkpoint.save_draw`` (fp32, or cast to bf16) is read by the
    port's ``load_bank`` against its meta skeleton: every leaf bit for
    bit, the metas as written, the fingerprint the JAX package's."""
    cfg = jsmoke("qwen3-1.7b")
    bank = str(tmp_path / "bank")
    draws = []
    for r in range(3):
        p = jax.tree.map(lambda l, r=r: (l + r).astype(dtype),
                         jinit(cfg, jax.random.PRNGKey(r)))
        draws.append(p)
        jckpt.save_draw(bank, p, jckpt.DrawMeta(**_meta(cfg.name, r, dtype)),
                        step=r)
    like = skeleton(get_smoke_config("qwen3-1.7b"))
    if dtype == "bfloat16":
        like = tu.tree_map(lambda t: torch.empty(t.shape,
                                                 dtype=torch.bfloat16,
                                                 device="meta"), like)
    assert checkpoint.tree_fingerprint(like) == \
        jckpt.tree_fingerprint(draws[0])
    stacked, metas = checkpoint.load_bank(bank, like, k=2,
                                          expect_arch=cfg.name)
    assert [m.round for m in metas] == [1, 2]
    assert {m.dtype for m in metas} == {dtype}
    want = jax.tree.map(lambda *ls: jnp.stack(ls), *draws[1:])
    for (name, got), w in zip(tu.leaves_with_names(stacked),
                              jax.tree.leaves(want)):
        assert str(got.dtype) == f"torch.{dtype}", name
        assert tuple(got.shape) == w.shape and _bits(got) == _bits(w), name
    # the facade's entry is the same function
    s2, _ = api.FSGLD.load_bank(bank, like, k=2)
    assert all(torch.equal(a, b) for a, b in zip(tu.leaves(s2),
                                                 tu.leaves(stacked)))


def test_a_port_bank_reads_through_the_jax_package(tmp_path):
    """A bank the port writes (danube's smoke parameters) is read by
    ``repro.checkpoint.load_bank`` against its own ``init_params``
    skeleton: equal config_hash, the port's bits (bf16 leaves: the next
    test)."""
    tcfg = get_smoke_config(ARCH)
    bank = str(tmp_path / "bank")
    draws = [init_params(tcfg, torch.Generator().manual_seed(r))
             for r in range(2)]
    for r, p in enumerate(draws):
        checkpoint.save_draw(bank, p, checkpoint.DrawMeta(
            **_meta(tcfg.name, r)), step=r)
    jlike = jinit(jsmoke(ARCH), jax.random.PRNGKey(0))
    stacked, metas = jckpt.load_bank(bank, jlike, expect_arch=ARCH)
    assert {m.config_hash for m in metas} == {jckpt.tree_fingerprint(jlike)}
    want = tu.tree_map(lambda *ls: torch.stack(ls), *draws)
    for w, got in zip(tu.leaves(want), jax.tree.leaves(stacked)):
        assert _bits(w) == _bits(got)


def test_bf16_leaves_round_trip_through_both_packages(tmp_path):
    tree = _numpy_tree(1)
    mine = _to_torch(tree)
    checkpoint.save(str(tmp_path / "t"), mine)
    got, _, _ = jckpt.restore(str(tmp_path / "t"), tree)
    assert np.asarray(got["emb"]).dtype.str == "|V2"
    assert _bits(got["emb"]) == _bits(tree["emb"])
    jckpt.save(str(tmp_path / "j"), tree)
    back, step, extra = checkpoint.restore(str(tmp_path / "j"), mine)
    assert back["emb"].dtype == torch.bfloat16 and (step, extra) == (0, {})
    for a, b in zip(tu.leaves(back), tu.leaves(mine)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# atomic writes and corruption
# ---------------------------------------------------------------------------

def test_atomic_save_never_leaves_a_half_checkpoint(tmp_path):
    path = str(tmp_path / "ck")
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    checkpoint.save(path, tree, step=1)
    checkpoint.save(path, {"w": tree["w"] + 1}, step=2)
    assert not [x for x in os.listdir(tmp_path) if x.startswith(".tmp")]
    got, step, _ = checkpoint.restore(path, tree)
    assert step == 2 and torch.equal(got["w"], tree["w"] + 1)
    truncate_file(os.path.join(path, "arrays.npz"))
    with pytest.raises(checkpoint.CorruptCheckpointError, match="torn"):
        checkpoint.restore(path, tree)
    with pytest.raises(ValueError, match="key paths"):
        checkpoint.save(path, tree)
        checkpoint.restore(path, {"v": tree["w"]})


def test_a_manifest_without_a_hash_falls_back_to_the_crc(tmp_path):
    """Legacy manifests carry no ``arrays_sha256``: the members' CRC-32
    then guards the bytes, and a flipped byte is corrupt."""
    import json
    path = str(tmp_path / "ck")
    tree = {"w": torch.arange(4096.0), "b": torch.ones(3, 2,
                                                        dtype=torch.bfloat16)}
    checkpoint.save(path, tree, step=3)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    for k in ("arrays_sha256", "schema", "meta", "fingerprint"):
        del manifest[k]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    got, step, _ = checkpoint.restore(path, tree)
    assert step == 3 and all(torch.equal(got[k], tree[k]) for k in tree)
    assert checkpoint.read_meta(path) is None
    apath = os.path.join(path, "arrays.npz")
    with open(apath, "r+b") as f:
        f.seek(os.path.getsize(apath) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(checkpoint.CorruptCheckpointError, match="CRC-32"):
        checkpoint.restore(path, tree)


def test_a_garbled_manifest_is_corrupt(tmp_path):
    path = str(tmp_path / "ck")
    checkpoint.save(path, {"w": torch.ones(2)},
                    meta=checkpoint.DrawMeta(arch="a"))
    assert checkpoint.read_meta(path).arch == "a"
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(checkpoint.CorruptCheckpointError, match="JSON"):
        checkpoint.read_meta(path)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config(ARCH)


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0))


def _fill_bank(bank, cfg, params, n=3):
    return [checkpoint.save_draw(
        bank, tu.tree_map(lambda l, r=r: l + r, params),
        checkpoint.DrawMeta(**_meta(cfg.name, r)), step=r)
        for r in range(n)]


@pytest.mark.parametrize("mode", ["truncate", "garbage", "missing"])
def test_load_bank_degrades_around_a_corrupt_draw(tmp_path, cfg, params,
                                                  mode):
    bank = str(tmp_path / "bank")
    paths = _fill_bank(bank, cfg, params, n=3)
    corrupt_draw(paths[1], mode=mode)
    with pytest.warns(UserWarning, match="corrupt"):
        stacked, metas = checkpoint.load_bank(bank, params)
    assert tu.leaves(stacked)[0].shape[0] == 2
    assert [m.round for m in metas] == [0, 2]
    assert torch.equal(stacked["final_norm"][1], params["final_norm"] + 2)


def test_load_bank_backfills_to_k(tmp_path, cfg, params):
    bank = str(tmp_path / "bank")
    paths = _fill_bank(bank, cfg, params, n=3)
    corrupt_draw(paths[2], mode="truncate")
    with pytest.warns(UserWarning, match="serving 2 of 2"):
        stacked, metas = checkpoint.load_bank(bank, params, k=2)
    assert [m.round for m in metas] == [0, 1]


def test_load_bank_refuses_all_corrupt_missing_and_empty(tmp_path, cfg,
                                                         params):
    bank = str(tmp_path / "bank")
    for p in _fill_bank(bank, cfg, params, n=2):
        corrupt_draw(p, mode="garbage")
    with pytest.raises(ValueError, match="no servable draws"):
        checkpoint.load_bank(bank, params)
    with pytest.raises(ValueError, match="does not exist"):
        checkpoint.load_bank(str(tmp_path / "nope"), params)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no complete draw"):
        checkpoint.load_bank(str(tmp_path / "empty"), params)
    with pytest.raises(ValueError, match="requested"):
        checkpoint.load_bank(bank, params, k=3)


def test_another_archs_bank_is_refused(tmp_path, cfg, params):
    bank = str(tmp_path / "bank")
    _fill_bank(bank, cfg, params, n=1)
    other = skeleton(get_smoke_config("qwen3-1.7b"))
    with pytest.raises(ValueError, match="different arch/config"):
        checkpoint.load_bank(bank, other)
    with pytest.raises(ValueError, match="server expects"):
        checkpoint.load_bank(bank, params, expect_arch="qwen3-1.7b")
    with pytest.raises(ValueError, match="refused"):
        EnsembleServer(get_smoke_config("qwen3-1.7b"), bank=bank,
                       device="cpu")


# ---------------------------------------------------------------------------
# the server on a bank
# ---------------------------------------------------------------------------

def test_server_loads_the_freshest_draws_cast_for_serving(tmp_path, cfg,
                                                          params):
    """``FSGLD.serve(bank=)``: the freshest K draws, oldest first, each
    the bank's draw cast as ``serving_params`` casts it; the served
    tokens are those of a server given the same draws directly."""
    from repro_torch.models import serving_params
    bank = str(tmp_path / "bank")
    _fill_bank(bank, cfg, params, n=3)
    srv = api.FSGLD.serve(api.Serving(arch=ARCH, draws=2, device="cpu"),
                          bank=bank)
    assert srv.n_draws == 2 and [m.round for m in srv.metas] == [1, 2]
    want = serving_params(tu.tree_map(
        lambda l: torch.stack([l + 1, l + 2]), params))
    for a, b in zip(tu.leaves(srv.draws), tu.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    direct = EnsembleServer(cfg, draws=tu.tree_map(
        lambda l: torch.stack([l + 1, l + 2]), params), device="cpu")
    r1, r2 = (s.generate(gen=3, batch=2, prompt_len=8)
              for s in (srv, direct))
    assert torch.equal(r1.tokens, r2.tokens)
    assert srv.refresh(backoff_s=0.0) is False  # nothing new


def test_refresh_hot_swaps_fresh_draws(tmp_path, cfg, params):
    bank = str(tmp_path / "bank")
    _fill_bank(bank, cfg, params, n=1)
    srv = EnsembleServer(cfg, bank=bank, n_draws=2, device="cpu")
    assert srv.n_draws == 1  # the sampler is still filling the bank
    checkpoint.save_draw(bank, tu.tree_map(lambda l: l + 5, params),
                         checkpoint.DrawMeta(**_meta(cfg.name, 5)), step=5)
    assert srv.refresh(backoff_s=0.0) is True
    assert srv.n_draws == 2 and [m.round for m in srv.metas] == [0, 5]


def test_server_survives_a_corrupted_refresh(tmp_path, cfg, params):
    bank = str(tmp_path / "bank")
    _fill_bank(bank, cfg, params, n=1)
    srv = EnsembleServer(cfg, bank=bank, device="cpu")
    before = tu.leaves(srv.draws)[0].clone()
    for p in checkpoint.list_draws(bank):
        corrupt_draw(p, mode="garbage")
    checkpoint.save_draw(bank, params, checkpoint.DrawMeta(
        **_meta(cfg.name, 9)), step=9)
    corrupt_draw(checkpoint.list_draws(bank)[-1], mode="truncate")
    with pytest.warns(UserWarning, match="keeping the previous"):
        assert srv.refresh(retries=1, backoff_s=0.0) is False
    assert srv.n_draws == 1 and torch.equal(before, tu.leaves(srv.draws)[0])


def test_server_retries_flaky_reads_with_backoff(tmp_path, cfg, params):
    """``flaky_io`` fails the first manifest read: refresh retries and
    succeeds. A flaky ARRAY read degrades through the corrupt-draw skip
    instead."""
    bank = str(tmp_path / "bank")
    _fill_bank(bank, cfg, params, n=1)
    srv = EnsembleServer(cfg, bank=bank, device="cpu")
    checkpoint.save_draw(bank, tu.tree_map(lambda l: l + 5, params),
                         checkpoint.DrawMeta(**_meta(cfg.name, 5)), step=5)
    with flaky_io(1, match="manifest.json") as calls:
        assert srv.refresh(retries=2, backoff_s=0.0) is True
    assert calls[0] == 1 and srv.n_draws == 2
    checkpoint.save_draw(bank, params, checkpoint.DrawMeta(
        **_meta(cfg.name, 6)), step=6)
    with flaky_io(1, match=".npz") as calls, \
            pytest.warns(UserWarning, match="skipped 1 corrupt"):
        assert srv.refresh(backoff_s=0.0) is True
    assert calls[0] == 1 and [m.round for m in srv.metas] == [0, 5]


def test_the_initial_load_fails_hard(tmp_path, cfg, params):
    bank = str(tmp_path / "bank")
    corrupt_draw(_fill_bank(bank, cfg, params, n=1)[0], mode="garbage")
    with pytest.raises(ValueError, match="no servable"):
        EnsembleServer(cfg, bank=bank, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        EnsembleServer(cfg, bank=bank, draws=params, device="cpu")


def test_a_legacy_checkpoint_serves_as_one_draw(tmp_path, cfg, params):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, params, step=4)
    srv = EnsembleServer(cfg, bank=path, n_draws=1, device="cpu")
    assert srv.n_draws == 1 and srv.metas == [None]


# ---------------------------------------------------------------------------
# obs.trace
# ---------------------------------------------------------------------------

def test_trace_spans_and_events_round_trip(tmp_path, capsys):
    path = str(tmp_path / "t.jsonl")
    assert not obs.enabled()
    assert obs.span("x") is obs.span("y")  # the shared no-op
    obs.configure(path, echo=True)
    try:
        with obs.span("outer", a=1):
            with obs.span("inner"):
                obs.event("ping", n=2)
    finally:
        obs.configure()
    recs = obs.read_jsonl(path)
    assert [(r["type"], r["name"]) for r in recs] == [
        ("event", "ping"), ("span", "inner"), ("span", "outer")]
    assert recs[0]["parent"] == "inner" and recs[1]["parent"] == "outer"
    assert recs[2]["depth"] == 0 and recs[2]["a"] == 1
    assert recs[2]["dur_s"] >= recs[1]["dur_s"] >= 0
    assert "ping n=2" in capsys.readouterr().out


def test_snapshot_io_emits_its_spans(tmp_path):
    path = str(tmp_path / "t.jsonl")
    obs.configure(path)
    try:
        snaps = str(tmp_path / "s")
        checkpoint.save_snapshot(snaps, {"a": torch.ones(2)}, rounds_done=1)
        corrupt_draw(checkpoint.list_snapshots(snaps)[0][1], "garbage")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert checkpoint.latest_snapshot(snaps, {"a": torch.ones(2)}) \
                == (None, 0)
    finally:
        obs.configure()
    names = [r["name"] for r in obs.read_jsonl(path)]
    assert names == ["snapshot.save", "snapshot.corrupt",
                     "snapshot.restore"]
