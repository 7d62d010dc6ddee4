"""The federated input pipeline (``repro_torch.data.pipeline``) against
the JAX package's (``repro.data.pipeline``): the reference's three
pipeline tests (``tests/test_pipeline_sharding.py``), each run on both
packages with the same seeds and held bitwise: the epoch batches, the
scheduled client ids and their batches, the categorical draws; and
that without CUDA the pipeline refuses to stage on a device it was not
given."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jp
from repro_torch.data import pipeline as tp
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)


def test_client_dataset_epochs_cover_all_as_the_reference():
    data = {"x": np.arange(10)[:, None]}
    out = []
    for mod in (jp, tp):
        ds = mod.ClientDataset(data, seed=0)
        seen = []
        for _ in range(7):   # one epoch and a reshuffled second
            seen.extend(ds.next_batch(2)["x"][:, 0].tolist())
        out.append(seen)
    assert out[0] == out[1]
    assert sorted(out[1][:10]) == list(range(10))


def test_pipeline_prefetch_and_schedule_as_the_reference():
    def clients(mod):
        return [mod.ClientDataset(
            {"x": np.arange(8 * 2).reshape(8, 2) + 100 * i}, seed=i)
            for i in range(3)]
    jpipe = jp.FederatedPipeline(clients(jp), batch_size=4,
                                 schedule=jp.categorical_schedule(
                                     [0.5, 0.3, 0.2], seed=1), prefetch=2)
    tpipe = tp.FederatedPipeline(clients(tp), batch_size=4,
                                 schedule=tp.categorical_schedule(
                                     [0.5, 0.3, 0.2], seed=1), prefetch=2,
                                 device="cpu")
    rr = tp.FederatedPipeline(clients(tp), batch_size=4,
                              schedule=tp.round_robin(3), device="cpu")
    for expect in [0, 1, 2, 0, 1]:
        assert next(rr)[0] == expect
    for _ in range(9):
        js, jb = next(jpipe)
        ts, tb = next(tpipe)
        assert js == ts
        assert isinstance(tb["x"], torch.Tensor)
        want = np.asarray(jb["x"])   # JAX holds int64 as int32
        assert tb["x"].numpy().astype(want.dtype).tobytes() == \
            want.tobytes()


def test_categorical_schedule_draws_as_the_reference():
    js = jp.categorical_schedule([0.7, 0.2, 0.1], seed=0)
    ts = tp.categorical_schedule([0.7, 0.2, 0.1], seed=0)
    a = [next(js) for _ in range(2000)]
    b = [next(ts) for _ in range(2000)]
    assert a == b
    freq = np.bincount(b, minlength=3) / 2000
    np.testing.assert_allclose(freq, [0.7, 0.2, 0.1], atol=0.03)


def test_pipeline_refuses_a_quiet_cpu_device(monkeypatch):
    """device=None means 'cuda': without it the pipeline raises, naming
    device='cpu', before it stages a batch; with 'cpu' it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clients = [tp.ClientDataset({"x": np.arange(8)[:, None] + 10 * i},
                                seed=i) for i in range(2)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.FederatedPipeline(clients, 2, tp.round_robin(2))
    pipe = tp.FederatedPipeline(clients, 2, tp.round_robin(2), device="cpu")
    cid, batch = next(pipe)
    assert cid == 0 and batch["x"].device.type == "cpu"
