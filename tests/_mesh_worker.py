"""One rank of the CPU mesh tests (``tests/test_torch_mesh.py``).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/_mesh_worker.py CASE OUT_DIR

Starts a gloo process group from the environment, builds the CASE's
mesh, runs every check of the case on this rank and writes
OUT_DIR/rank<r>.json: a list of [name, ok, detail]. Each check holds a
mesh run against the same run on this one process with no mesh (the
one-device engine, server or driver), bitwise unless its detail states
a bound. Cases:

  data   (data, model) = (2, 1): the engine on packed, per_leaf and vmap
         with 4 and 3 chains; FA-LD; a streamed run; snapshots and a
         resume; Serving(mesh=) at K = 4 (the draws on 'data')
  model  (1, 2): the same six engine runs; refresh_bank_mesh over
         model = 2; a run with refresh_every; Serving(mesh=) at K = 4
         (replicated); the embedding's vocab-parallel lookup of
         replicated tokens (``models.model._embed`` of a table whose
         vocab is sharded over 'model') against ``table[tokens]``, its
         value and its gradient; the attention scan, decode attention
         and RWKV decode's state read on local head shards against the
         plain tensors
  train  launch/train.py --multi-pod --smoke on a (2, 1, 1) mesh
         against the driver's run without torchrun's environment
  shards (1, 2): what the model runs on each rank's shard of a sequence
         or of a cache's slots: decode attention over a cache whose
         slots ``sharding.rules.cache_specs`` shards over 'model' (a
         smoke qwen3 with one KV head), the softmax split across the
         slot shards, against the plain tensors' within 1e-6 (fp32),
         with a ring buffer holding -1 slots, a row whose slots on one
         rank are all empty and a row with none valid anywhere; and
         ``rglru_forward`` with the sequence sharded over 'model' (the
         conv's halo, the scan's carries) against the plain one within
         1e-6 (its value and h_last; its gradients within 1e-6 (1 + max
         |ref|)), with and without a carried state, and its conv and
         scan alone (the path where only the gates come out sharded); and
         ``rwkv_forward`` with its rows sharded over 'model' (u's
         gradient summed over the rows' ranks)
  health (2, 1): recovery and telemetry across the data ranks: a NaN'd
         chain respawned from a donor on the other rank, and a
         quarantine under a federation schedule, with telemetry's probe
         rows (the trace, the health words, the probe reference and
         every metric row)
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs.base import SamplerConfig  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import surrogate as tsur  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.workloads import mlp_log_lik, mlp_problem  # noqa: E402

RESULTS = []


def check(name, fn):
    try:
        detail = fn()
        RESULTS.append([name, True, detail or ""])
    except Exception:  # a failed check is reported, the rest still run
        RESULTS.append([name, False, traceback.format_exc()[-2000:]])


def equal(a, b):
    la, lb = tu.leaves(a), tu.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape, (x.shape, y.shape)
        assert torch.equal(x, y), float((x - y).abs().max())


def mlp_engine(executor, mesh=None, **kw):
    g = torch.Generator().manual_seed(3)
    data, bank, theta0 = mlp_problem(g, S=3, n=40, din=5, hid=7, dout=2)
    cfg = SamplerConfig(method="fsgld", step_size=1e-3, num_shards=3,
                        local_updates=3, prior_precision=1.0,
                        surrogate="scalar")
    eng = teng.MeshChainEngine(
        mlp_log_lik, cfg, data, 8, bank=bank, use_kernel=executor != "vmap",
        packed={"packed": True, "per_leaf": False}.get(executor),
        mesh=mesh, **kw)
    return eng, theta0


def engine_runs(mesh):
    for executor in ("packed", "per_leaf", "vmap"):
        for n in (4, 3):
            def run(executor=executor, n=n):
                outs = []
                for m in (mesh, None):
                    eng, theta0 = mlp_engine(executor, m)
                    outs.append(eng.run(torch.Generator().manual_seed(5),
                                        theta0, 3, n_chains=n))
                equal(*outs)
                assert tu.leaves(outs[0])[0].shape[:2] == (n, 9)
            check(f"engine {executor} C={n}", run)


def gauss_engine(mesh, **kw):
    g = torch.Generator().manual_seed(7)
    S, n, D = 4, 12, 6
    x = torch.randn(S, 1, D, generator=g) * 2 + torch.randn(S, n, D,
                                                            generator=g)
    bank = tsur.make_bank(x.mean(1), torch.full((S, D), float(n)), "diag")
    cfg = SamplerConfig(method="fsgld", step_size=1e-3, num_shards=S,
                        local_updates=2, prior_precision=1.0)

    def ll(theta, batch):
        return -0.5 * torch.sum((batch["x"] - theta) ** 2)

    eng = teng.MeshChainEngine(ll, cfg, {"x": x}, 4, bank=bank,
                               use_kernel=True, mesh=mesh, **kw)
    return eng, 0.1 * torch.randn(D, generator=g)


def case_data(mesh):
    engine_runs(mesh)

    def fald():
        outs = []
        for m in (mesh, None):
            eng, theta0 = mlp_engine("packed", m, aggregation="fald")
            outs.append(eng.run(torch.Generator().manual_seed(6), theta0, 3,
                                n_chains=3, federation="topk-1%"))
        equal(*outs)
    check("FA-LD packed C=3 with top-k compression", fald)

    def stream():
        outs = []
        for m in (mesh, None):
            eng, theta0 = mlp_engine("packed", m)
            outs.append(eng.run(torch.Generator().manual_seed(8), theta0, 4,
                                n_chains=2, reassign="permutation",
                                stream=api.Stream(resident=2)))
        eng, theta0 = mlp_engine("packed", None)
        equal(outs[0], eng.run(torch.Generator().manual_seed(8), theta0, 4,
                               n_chains=2, reassign="permutation"))
        equal(*outs)
    check("streamed packed C=2, 2 resident", stream)

    def snapshots():
        # rank 0 makes the directory; every rank reads and writes there
        root = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(root, src=0)
        snaps = os.path.join(root[0], "snaps")
        eng, theta0 = gauss_engine(mesh)
        kw = dict(n_chains=3, federation="delayed-5x",
                  snapshot_every=2, snapshot_path=snaps)
        whole = gauss_engine(None)[0].run(torch.Generator().manual_seed(9),
                                          theta0, 6, n_chains=3,
                                          federation="delayed-5x")
        eng.run(torch.Generator().manual_seed(9), theta0, 4, **kw)
        resumed = eng.run(torch.Generator().manual_seed(9), theta0, 6,
                          resume=True, **kw)
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(root[0])
        equal(resumed, whole)
    check("snapshots every 2 rounds, then a resume at round 4", snapshots)

    check("Serving(mesh=) K=4 on 'data'", lambda: serving(mesh, 4, 2))
    check("Serving(mesh=) K=3 replicated (3 % 2 != 0)",
          lambda: serving(mesh, 3, 3))


def serving(mesh, k, held):
    """K draws served on the mesh against the one-device server: every
    token and statistic bitwise; ``held`` draws on this rank."""
    spec = dict(draws=k, arch="qwen3-1.7b", smoke=True, device="cpu")
    a = api.FSGLD.serve(api.Serving(mesh=mesh, **spec), seed=3)
    b = api.FSGLD.serve(api.Serving(**spec), seed=3)
    assert tu.leaves(a.draws)[0].shape[0] == held and a.n_draws == k
    ra = a.generate(batch=2, prompt_len=8, gen=4)
    rb = b.generate(batch=2, prompt_len=8, gen=4)
    for f in ("tokens", "mean_logprob", "entropy", "mutual_info",
              "token_var"):
        equal(getattr(ra, f), getattr(rb, f))
    assert ra.n_draws == k


def case_model(mesh):
    engine_runs(mesh)

    def refresh_bank():
        eng, _ = gauss_engine(mesh)
        theta = torch.linspace(-1, 1, 6)
        a = teng.refresh_bank_mesh(eng.log_lik_fn, eng.shard_data, theta,
                                   mesh)
        b = tfed.refresh_bank(eng.log_lik_fn, eng.shard_data, theta)
        equal((a.means, a.precs, a.global_.mean, a.global_.prec),
              (b.means, b.precs, b.global_.mean, b.global_.prec))
    check("refresh_bank_mesh over model=2", refresh_bank)

    def refresh_run():
        outs = []
        for m in (mesh, None):
            eng, theta0 = gauss_engine(m)
            outs.append(eng.run(torch.Generator().manual_seed(2), theta0, 5,
                                n_chains=3, refresh_every=2))
        equal(*outs)
    check("engine run with refresh_every=2", refresh_run)

    check("Serving(mesh=) K=4 over a data axis of 1",
          lambda: serving(mesh, 4, 4))

    for d_on_data in (False, True):
        check(f"vocab-parallel lookup, D on data: {d_on_data}",
              lambda d_on_data=d_on_data: vocab_lookup(mesh, d_on_data))
    check("attention on local shards", lambda: local_shards(mesh))


def local_shards(mesh):
    """What the model runs on each rank's own (batch, head) shards of
    DTensors (the pod meshes' layout): the plain attention scan with its
    flash backward (heads over 'model'), decode attention over a cache
    whose slots are whole, and RWKV decode's state read: each equal to
    the plain tensors' result, values and gradients, bitwise."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as TL
    g = torch.Generator().manual_seed(6)
    B, S, H, hd = 2, 12, 4, 8
    q, k, v, do = (torch.randn(B, S, H, hd, generator=g) for _ in range(4))
    pos = torch.arange(S).expand(B, S)
    heads = [Replicate(), Shard(2)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = fa.scan_attention(*plain, pos, pos, block_k=4)
    want.backward(do)
    dts = [distribute_tensor(t, mesh, heads).requires_grad_(True)
           for t in (q, k, v)]
    got = fa.scan_attention(*dts, pos, pos, block_k=4)
    got.backward(distribute_tensor(do, mesh, heads))
    assert got.placements == tuple(heads)
    assert torch.equal(got.full_tensor(), want.detach())
    for a, b in zip(dts, plain):
        assert torch.equal(a.grad.full_tensor(), b.grad)
    kc, vc = (torch.randn(B, S, H, hd, generator=g) for _ in range(2))
    q1 = torch.randn(B, 1, H, hd, generator=g)
    kv_pos = torch.arange(S).expand(B, S)
    qp = torch.tensor([S - 1, S // 2])
    want = TL.decode_attention(q1, kc, vc, kv_pos, qp)
    got = TL.decode_attention(*(distribute_tensor(t, mesh, heads)
                                for t in (q1, kc, vc)), kv_pos, qp)
    assert torch.equal(got.full_tensor(), want)
    r = torch.randn(B, H, hd, generator=g)
    M = torch.randn(B, H, hd, hd, generator=g)
    on = [Replicate(), Shard(1)]
    got = TL._state_read(distribute_tensor(r, mesh, on),
                         distribute_tensor(M, mesh, on))
    assert torch.equal(got.full_tensor(), TL._state_read(r, M))
    return "scan, decode attention and the state read on 'model' shards"


def vocab_lookup(mesh, d_on_data):
    """The table (V, D) sharded by vocabulary over 'model' (and along D
    over 'data', as the train layout shards it), looked up by replicated
    tokens that fall in both vocab shards, some twice: the rows equal
    table[tokens] and the table's gradient the plain one, bitwise."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import model as TM
    g = torch.Generator().manual_seed(5)
    table = torch.randn(12, 8, generator=g)
    tokens = torch.tensor([[0, 11, 5, 6], [6, 3, 11, 9]])
    w = torch.randn(2, 4, 8, generator=g)
    plain = table.clone().requires_grad_(True)
    want = plain[tokens]
    (want * w).sum().backward()
    dt = distribute_tensor(table, mesh, [Shard(1) if d_on_data
                                         else Replicate(), Shard(0)])
    dt.requires_grad_(True)
    got = TM._embed(dt, tokens)
    (got.full_tensor() * w).sum().backward()
    assert torch.equal(got.full_tensor(), want.detach())
    assert dt.grad.placements == dt.placements
    assert torch.equal(dt.grad.full_tensor(), plain.grad)
    return f"rows {tuple(got.shape)} placed {got.placements}"


def slot_decode(mesh):
    """Decode attention over a cache placed as ``cache_specs`` places a
    smoke qwen3's with one KV head on a model axis of 2 (its slots over
    'model'): each rank attends its own slots and the softmax is reduced
    across them. Rows: 0 a ring buffer that has wrapped (slot positions
    12..15 then 4..11), 1 slots 0..3 filled and the rest -1 (every slot
    on rank 1 empty), 2 slots 6..9 filled with positions above its query
    (no valid slot anywhere: the plain softmax's uniform weights)."""
    import dataclasses
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM
    from repro_torch.sharding import rules
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              num_kv_heads=1)
    B, S, H, K, hd = 3, 12, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache = TM.init_cache(cfg, B, S, dtype=torch.float32)["blocks"]["l0"]
    specs = rules.cache_specs({"blocks": {"l0": cache}},
                              {"data": 1, "model": 2})["blocks"]["l0"]
    # (periods, B, S, K, hd): the slots over 'model', K = 1 not split
    assert tuple(specs["k"])[2:4] == ("model", None), specs["k"]
    pl, pl_pos = (rules.placements(rules.P(*tuple(specs[n])[1:]), mesh)
                  for n in ("k", "pos"))
    assert pl == [Shard(0), Shard(1)] and pl_pos == [Shard(0), Replicate()]
    g = torch.Generator().manual_seed(11)
    q = torch.randn(B, 1, H, hd, generator=g)
    kc, vc = (torch.randn(B, S, K, hd, generator=g) for _ in range(2))
    kv_pos = torch.full((B, S), -1, dtype=torch.int32)
    kv_pos[0] = torch.tensor([12, 13, 14, 15] + list(range(4, 12)))
    kv_pos[1, :4] = torch.arange(4)
    kv_pos[2, 6:10] = torch.arange(20, 24)
    qp = torch.tensor([15, 3, 9])
    want = TL.decode_attention(q, kc, vc, kv_pos, qp)
    got = TL.decode_attention(
        distribute_tensor(q, mesh, pl_pos),
        *(distribute_tensor(t, mesh, pl) for t in (kc, vc)),
        distribute_tensor(kv_pos, mesh, pl_pos), qp)
    err = float((got.full_tensor() - want).abs().max())
    assert err <= 1e-6, err
    # row 2: no valid slot, the mean of its values for every head
    assert torch.allclose(want[2, 0], vc[2, :, 0].mean(0).expand(H, hd),
                          atol=1e-6)
    return f"max |err| {err:.3g}"


def seq_rglru(mesh, carried):
    """``rglru_forward`` of x (B, S, D) sharded along the sequence over
    'model' (as DTensor places the pod meshes' prefill), its parameters
    replicated: y and h_last against the plain tensors' within 1e-6, the
    gradients of every input within 1e-6 (1 + max |ref|)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers as TL
    g = torch.Generator().manual_seed(12)
    B, S, D = 2, 16, 8
    p = {"w_x": torch.randn(D, D, generator=g) / D ** 0.5,
         "w_gate": torch.randn(D, D, generator=g) / D ** 0.5,
         "w_rec": torch.randn(D, D, generator=g) / D ** 0.5,
         "w_inp": torch.randn(D, D, generator=g) / D ** 0.5,
         "w_out": torch.randn(D, D, generator=g) / D ** 0.5,
         "conv_w": torch.randn(TL.RGLRU_CONV, D, generator=g) * 0.5,
         "lam": torch.randn(D, generator=g)}
    x = torch.randn(B, S, D, generator=g)
    h0 = torch.randn(B, D, generator=g) if carried else None
    w = torch.randn(B, S, D, generator=g)
    wl = torch.randn(B, D, generator=g)
    # the pod meshes' layout: the rows over 'data' (here of size 1), the
    # sequence over 'model'
    rep, rows = [Replicate(), Replicate()], [Shard(0), Replicate()]
    seq = [Shard(0), Shard(1)]

    def run(x, p, h0):
        y, h_last = TL.rglru_forward(x, p, h0)
        return y, h_last

    plain = [x.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in p.values()]
    yp, hp = run(plain[0], dict(zip(p, plain[1:])), h0)
    ((yp * w).sum() + (hp * wl).sum()).backward()
    dts = [distribute_tensor(x, mesh, seq).requires_grad_(True)] + [
        distribute_tensor(t, mesh, rep).requires_grad_(True)
        for t in p.values()]
    yd, hd = run(dts[0], dict(zip(p, dts[1:])), None if h0 is None
                 else distribute_tensor(h0, mesh, rows))
    assert yd.placements == tuple(seq), yd.placements
    ((yd * distribute_tensor(w, mesh, seq)).sum()
     + (hd * distribute_tensor(wl, mesh, rows)).sum()).backward()
    errs = {"y": float((yd.full_tensor() - yp).abs().max()),
            "h_last": float((hd.full_tensor() - hp).abs().max())}
    bad = {k: e for k, e in errs.items() if not e <= 1e-6}
    bad.update(_grad_errors(["x"] + list(p), dts, plain))
    assert not bad, bad
    return f"max |err| {max(errs.values()):.3g}"


def _grad_errors(names, dts, plain) -> dict:
    """{'d' + name: (max |err|, max |ref|)} of the gradients off by more
    than 1e-6 (1 + max |ref|): a weight's gradient sums over the rows in
    another order (each shard's, then across the ranks), so it is held
    at the scale of the tensor, not of each element."""
    bad = {}
    for name, a, b in zip(names, dts, plain):
        err, ref = (float((a.grad.full_tensor() - b.grad).abs().max()),
                    float(b.grad.abs().max()))
        if not err <= 1e-6 * (1 + ref):
            bad["d" + name] = (err, ref)
    return bad


def rwkv_rows(mesh):
    """``rwkv_forward`` of x (B, S, D) with its rows sharded over 'model'
    (the chunk loop on each rank's rows, ``_ChunkShards``), its parameters
    replicated: y, the state and the gradients of every input against the
    plain tensors' (u's gradient summed over the rows' ranks)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers as TL
    g = torch.Generator().manual_seed(13)
    B, S, H, hd = 2, 20, 2, 4
    D = H * hd
    p = {k: torch.randn(D, D, generator=g) / D ** 0.5
         for k in ("w_r", "w_k", "w_v", "w_o")}
    p.update({k: torch.rand(D, generator=g)
              for k in ("mu_r", "mu_k", "mu_v", "mu_w")})
    p.update(w0=torch.randn(D, generator=g) - 1.0,
             w_lora_a=torch.randn(D, TL.RWKV_LORA, generator=g) * 0.1,
             w_lora_b=torch.randn(TL.RWKV_LORA, D, generator=g) * 0.1,
             u=torch.randn(H, hd, generator=g))
    x = torch.randn(B, S, D, generator=g)
    w = torch.randn(B, S, D, generator=g)
    rep, rows = [Replicate(), Replicate()], [Replicate(), Shard(0)]
    plain = [x.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in p.values()]
    yp, sp = TL.rwkv_forward(plain[0], dict(zip(p, plain[1:])), chunk=8)
    ((yp * w).sum() + sp["S"].sum()).backward()
    dts = [distribute_tensor(x, mesh, rows).requires_grad_(True)] + [
        distribute_tensor(t, mesh, rep).requires_grad_(True)
        for t in p.values()]
    yd, sd = TL.rwkv_forward(dts[0], dict(zip(p, dts[1:])), chunk=8)
    ((yd * distribute_tensor(w, mesh, rows)).sum()
     + sd["S"].sum()).backward()
    bad = {}
    for name, a, b in [("y", yd, yp), ("S", sd["S"], sp["S"])]:
        d = (a.full_tensor() - b.detach()).abs()
        if not bool((d <= 1e-6 + 1e-6 * b.detach().abs()).all()):
            bad[name] = float(d.max())
    bad.update(_grad_errors(["x"] + list(p), dts, plain))
    assert not bad, bad
    return "y, S within 1e-6 + 1e-6 |ref|, gradients 1e-6 (1 + max |ref|)"


def seq_pieces(mesh):
    """The conv of a DTensor x (B, S, D) whose rows and sequence are
    sharded (``_SeqShards.conv``: each shard led by its halo) and the
    scan of a and b so sharded with a carried state (``_SeqShards.scan``
    / ``last``, the path where only the gates come out sequence-sharded):
    against ``_causal_conv1d`` and ``linear_scan`` of the plain tensors
    within 1e-6, and their gradients within 1e-6 (1 + max |ref|)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers as TL
    g = torch.Generator().manual_seed(14)
    B, S, D = 2, 16, 8
    x, wx = (torch.randn(B, S, D, generator=g) for _ in range(2))
    w = torch.randn(TL.RGLRU_CONV, D, generator=g)
    a = torch.rand(B, S, D, generator=g)
    b, wh = (torch.randn(B, S, D, generator=g) for _ in range(2))
    h0, wl = (torch.randn(B, D, generator=g) for _ in range(2))
    seq, rows = [Shard(0), Shard(1)], [Shard(0), Replicate()]
    pl = [seq, [Replicate(), Replicate()], seq, seq, rows]
    plain = [t.clone().requires_grad_(True) for t in (x, w, a, b, h0)]
    dts = [distribute_tensor(t, mesh, q).requires_grad_(True)
           for t, q in zip((x, w, a, b, h0), pl)]

    def run(x, w, a, b, h0, shards=None):
        if shards is None:
            h = TL.linear_scan(a, torch.cat([b[:, :1] + a[:, :1]
                                             * h0[:, None], b[:, 1:]], 1))
            return TL._causal_conv1d(x, w), h, h[:, -1]
        conv = shards.placed(shards.conv(shards.local(x), shards.operand(
            w, shards.channels(1))))
        state = shards.channels(1, rows=True)
        h = shards.scan(shards.local(a), shards.local(b),
                        shards.operand(h0, state))
        return conv, shards.placed(h), shards.last(h, state)

    want = run(*plain)
    got = run(*dts, shards=TL._SeqShards.of(dts[2]))
    loss = [(want[0] * wx).sum() + (want[1] * wh).sum()
            + (want[2] * wl).sum(),
            (got[0] * distribute_tensor(wx, mesh, seq)).sum()
            + (got[1] * distribute_tensor(wh, mesh, seq)).sum()
            + (got[2] * distribute_tensor(wl, mesh, rows)).sum()]
    for t in loss:
        t.backward()
    bad = {n: e for n, e in (
        (n, float((gt.full_tensor() - wt.detach()).abs().max()))
        for n, gt, wt in zip(("conv", "h", "h_last"), got, want))
        if not e <= 1e-6}
    bad.update(_grad_errors(["x", "conv_w", "a", "b", "h0"], dts, plain))
    assert not bad, bad
    return "conv, h and h_last within 1e-6"


def case_shards(mesh):
    check("decode attention over slot shards", lambda: slot_decode(mesh))
    for carried in (False, True):
        check(f"RG-LRU over sequence shards, carried: {carried}",
              lambda carried=carried: seq_rglru(mesh, carried))
    check("RG-LRU's conv and scan over sequence shards",
          lambda: seq_pieces(mesh))
    check("RWKV chunk loop over row shards", lambda: rwkv_rows(mesh))


def case_health(mesh):
    from repro_torch.core.health import Recovery
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.testing import ChaosSpec

    def same_out(a, b):
        (ta, ha, fa), (tb, hb, fb) = a, b
        equal(ta, tb)
        assert (ha.word == hb.word).all(), (ha.word, hb.word)
        assert ha.lp_ref is None or (ha.lp_ref.tobytes()
                                     == hb.lp_ref.tobytes())
        assert fa.names == fb.names
        for n in fa.names:
            assert fa.metrics[n].tobytes() == fb.metrics[n].tobytes(), n
        return f"words {ha.word.tolist()}"

    for executor in ("packed", "per_leaf", "vmap"):
        def respawn(executor=executor):
            # chain 2 (rank 1's block) takes chain 0's row (rank 0's)
            outs = []
            for m in (mesh, None):
                eng, theta0 = mlp_engine(executor, m)
                outs.append(eng.run(
                    torch.Generator().manual_seed(4), theta0, 4, n_chains=3,
                    reassign="permutation",
                    recovery=Recovery("respawn", divergence_threshold=50.0),
                    chaos=ChaosSpec(nan_chains=(2,), nan_rounds=(1,)),
                    telemetry=Telemetry(probe=True)))
            assert outs[1][1].word.tolist() == [0, 0, 1]
            return same_out(*outs)
        check(f"respawn across ranks {executor} C=3", respawn)

    def quarantine():
        outs = []
        for m in (mesh, None):
            eng, theta0 = gauss_engine(m)
            outs.append(eng.run(
                torch.Generator().manual_seed(6), theta0, 4, n_chains=4,
                federation="delayed-5x",
                recovery=Recovery("quarantine"),
                chaos=ChaosSpec(nan_chains=(3,), nan_rounds=(2,)),
                telemetry=Telemetry(probe=False)))
        assert outs[1][1].word.tolist() == [0, 0, 0, 3]
        return same_out(*outs)
    check("quarantine with a federation packed C=4", quarantine)


def case_train(out_dir):
    from repro_torch.launch import train
    argv = ["--smoke", "--device", "cpu", "--multi-pod", "--rounds", "2",
            "--local-updates", "2", "--fit-steps", "2", "--num-shards", "2",
            "--shard-size", "8", "--seq", "16", "--batch", "4",
            "--chains", "2", "--step-size", "1e-4"]

    def run():
        tr = train.run(train.parse_args(argv))
        # the one-device run in this process: outside torchrun's
        # environment and without --multi-pod, the driver builds no mesh
        env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE")}
        try:
            one = train.run(train.parse_args(
                [a for a in argv if a != "--multi-pod"]))
        finally:
            os.environ.update(env)
        equal(tr.finals, one.finals)
        return f"lls {tr.lls}"
    check("train --multi-pod --smoke", run)


def main() -> int:
    case, out_dir = sys.argv[1], sys.argv[2]
    lmesh.init_world("cpu")
    if case == "data":
        case_data(lmesh.make_sim_mesh(2, 1, "cpu"))
    elif case == "model":
        case_model(lmesh.make_sim_mesh(1, 2, "cpu"))
    elif case == "shards":
        case_shards(lmesh.make_sim_mesh(1, 2, "cpu"))
    elif case == "health":
        case_health(lmesh.make_sim_mesh(2, 1, "cpu"))
    else:
        case_train(out_dir)
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(RESULTS, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
