"""The port's telemetry spec, metric frames and exporters
(``repro_torch.obs.telemetry``, ``repro_torch.obs.exporters``) against the
JAX package's (``repro.obs``), and the serving CLI's request spans.

* ``Telemetry`` names and validation, ``MetricsFrame`` summary,
  last_round, concat and shape checks equal the reference's on the same
  numpy-made rows.
* Files cross packages: a port-written ``metrics.jsonl`` reads back
  bitwise (fp32) through ``repro.obs.read_metrics_jsonl`` and the
  reverse; a Prometheus textfile written by either package parses to the
  same dict through both parsers.
* ``repro_torch.launch.serve --log-jsonl`` writes the reference's
  ``serve.prefill`` / ``serve.decode`` spans and ``serve.request`` event,
  the spans' durations agreeing with the request's own times.
"""
import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.launch import serve as serve_cli
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)


def _rows(rounds=6, chains=3, seed=0, probe=True):
    rng = np.random.default_rng(seed)
    names = tobs.Telemetry(probe=probe).names
    return {n: (rng.normal(size=(rounds, chains))
                * 10.0 ** rng.integers(-8, 8)).astype(np.float32)
            for n in names}


@pytest.mark.parametrize("probe", [True, False])
@pytest.mark.parametrize("log_every", [None, 1, 3])
def test_telemetry_spec_matches_the_reference(probe, log_every):
    t = tobs.Telemetry(probe=probe, log_every=log_every)
    j = jobs.Telemetry(probe=probe, log_every=log_every)
    assert t.names == j.names and list(t.names) == sorted(t.names)
    assert tobs.TELEMETRY_PROBE_SALT == jobs.TELEMETRY_PROBE_SALT
    with pytest.raises(ValueError, match="log_every must be >= 1"):
        tobs.Telemetry(log_every=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_summary_last_round_concat_match_the_reference(seed):
    rows = _rows(seed=seed)
    t, j = tobs.MetricsFrame(dict(rows)), jobs.MetricsFrame(dict(rows))
    assert (t.names, t.rounds, t.n_chains) == (j.names, j.rounds, j.n_chains)
    assert t.summary() == j.summary()
    for n in t.names:
        np.testing.assert_array_equal(t.last_round()[n], j.last_round()[n])
    other = _rows(rounds=2, seed=seed + 7)
    tc = tobs.MetricsFrame.concat([t, tobs.MetricsFrame(dict(other))])
    jc = jobs.MetricsFrame.concat([j, jobs.MetricsFrame(dict(other))])
    assert tc.rounds == jc.rounds == 8
    for n in tc.names:
        np.testing.assert_array_equal(tc.metrics[n], jc.metrics[n])


def test_frame_shape_checks():
    with pytest.raises(AssertionError):
        tobs.MetricsFrame({})
    with pytest.raises(AssertionError):
        tobs.MetricsFrame({"a": np.zeros((2, 3)), "b": np.zeros((2, 4))})
    with pytest.raises(AssertionError):
        tobs.MetricsFrame({"a": np.zeros(3)})
    with pytest.raises(AssertionError):
        tobs.MetricsFrame.concat([tobs.MetricsFrame({"a": np.zeros((1, 2))}),
                                  tobs.MetricsFrame({"b": np.zeros((1, 2))})])


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_metrics_jsonl_crosses_packages_bitwise(tmp_path, writer, reader):
    rows = _rows(rounds=5, chains=4, seed=3)
    rows["theta_norm"][2, 1] = np.float32(np.pi)   # an inexact fp32 value
    w = tobs if writer == "port" else jobs
    r = tobs if reader == "port" else jobs
    path = str(tmp_path / "metrics.jsonl")
    w.write_metrics_jsonl(w.MetricsFrame(dict(rows)), path)
    back = r.read_metrics_jsonl(path)
    assert back.names == tuple(rows)
    for n, a in rows.items():
        assert back.metrics[n].dtype == np.float32
        np.testing.assert_array_equal(back.metrics[n], a)


def test_both_packages_write_the_same_bytes(tmp_path):
    rows = _rows(seed=4)
    for name, writer in (("jsonl", "write_metrics_jsonl"),
                         ("prom", "write_prometheus")):
        a, b = str(tmp_path / f"t.{name}"), str(tmp_path / f"j.{name}")
        getattr(tobs, writer)(tobs.MetricsFrame(dict(rows)), a)
        getattr(jobs, writer)(jobs.MetricsFrame(dict(rows)), b)
        assert open(a).read() == open(b).read()


@pytest.mark.parametrize("prefix", ["fsgld", "run7"])
def test_prometheus_parses_to_equal_dicts_in_both_packages(tmp_path, prefix):
    rows = _rows(rounds=3, chains=2, seed=5)
    path = str(tmp_path / "metrics.prom")
    tobs.write_prometheus(tobs.MetricsFrame(dict(rows)), path, prefix=prefix)
    t, j = tobs.parse_prometheus(path), jobs.parse_prometheus(path)
    assert t == j
    assert t[f"{prefix}_rounds_total"] == 3.0
    assert t[f'{prefix}_theta_norm{{chain="1"}}'] == pytest.approx(
        float(rows["theta_norm"][-1, 1]), rel=1e-8)
    assert t[f"{prefix}_grad_norm_mean"] == pytest.approx(
        float(np.mean(rows["grad_norm"])), rel=1e-8)
    empty = tmp_path / "empty.prom"
    empty.write_text("# nothing\n")
    with pytest.raises(AssertionError, match="no samples"):
        tobs.parse_prometheus(str(empty))


def test_serve_log_jsonl_writes_the_request_spans(tmp_path, capsys):
    """The serving CLI on the CPU: each request's prefill and decode spans
    and its ``serve.request`` event reach the JSONL, and each span's
    duration holds the request's own prefill / decode seconds (the span
    closes right after them)."""
    path = str(tmp_path / "serve.jsonl")
    assert serve_cli.main(["--smoke", "--device", "cpu", "--draws", "2",
                           "--batch", "2", "--prompt-len", "8", "--gen", "3",
                           "--log-jsonl", path]) == 0
    recs = tobs.read_jsonl(path)
    spans = {r["name"]: r for r in recs if r["type"] == "span"}
    req, = [r for r in recs if r["name"] == "serve.request"]
    assert set(spans) >= {"serve.prefill", "serve.decode"}
    assert spans["serve.prefill"]["prompt_len"] == 8
    assert spans["serve.decode"]["gen"] == 3
    assert req["n_draws"] == 2 and req["batch"] == 2
    for name, key in (("serve.prefill", "prefill_s"),
                      ("serve.decode", "decode_s")):
        dur = spans[name]["dur_s"]
        assert req[key] <= dur + 1e-6 and dur - req[key] < 0.05, \
            (name, dur, req[key])
    out = capsys.readouterr().out
    assert "serve.prefill" in out and "serve.request" in out
