"""MetricsFrame exporters: JSONL (round-major records) + Prometheus
textfile (counterpart of ``repro.obs.exporters``; the schema name
``repro-metrics-v1`` and the line formats are the reference's, so a file
written by either package reads back in the other, bitwise at fp32).
Both are plain-text, append-friendly formats an operator can tail /
node-exporter can scrape."""
from __future__ import annotations

import json

import numpy as np

from repro_torch.obs.telemetry import MetricsFrame


def write_metrics_jsonl(frame: MetricsFrame, path: str) -> None:
    """One header record (names + shape) then one record per round with
    the per-chain fp32 values of every metric."""
    with open(path, "w") as f:
        f.write(json.dumps({
            "type": "header", "schema": "repro-metrics-v1",
            "names": list(frame.names), "rounds": frame.rounds,
            "chains": frame.n_chains}) + "\n")
        for r in range(frame.rounds):
            rec = {"type": "round", "round": r}
            for name in frame.names:
                rec[name] = [float(v) for v in frame.metrics[name][r]]
            f.write(json.dumps(rec) + "\n")


def read_metrics_jsonl(path: str) -> MetricsFrame:
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert records and records[0].get("type") == "header", path
    head = records[0]
    assert head.get("schema") == "repro-metrics-v1", head.get("schema")
    names, rounds = head["names"], head["rounds"]
    rows = [r for r in records[1:] if r.get("type") == "round"]
    assert len(rows) == rounds, (len(rows), rounds)
    metrics = {
        n: np.asarray([rows[r][n] for r in range(rounds)], np.float32)
        for n in names}
    return MetricsFrame(metrics)


def write_prometheus(frame: MetricsFrame, path: str, *,
                     prefix: str = "fsgld") -> None:
    """Prometheus TEXTFILE format (node_exporter textfile collector):
    per-chain gauges of the FINAL round plus run-mean aggregates —
    the scrape-friendly projection of the frame (history stays in the
    JSONL)."""
    last = frame.last_round()
    mean = frame.summary()
    lines = [f"# HELP {prefix}_rounds_total communication rounds run",
             f"# TYPE {prefix}_rounds_total counter",
             f"{prefix}_rounds_total {frame.rounds}"]
    for name in frame.names:
        metric = f"{prefix}_{name}"
        lines.append(f"# HELP {metric} telemetry row '{name}' "
                     "(last round per chain; _mean = run mean)")
        lines.append(f"# TYPE {metric} gauge")
        for c, v in enumerate(last[name]):
            lines.append(f'{metric}{{chain="{c}"}} {float(v):.9g}')
        lines.append(f"{prefix}_{name}_mean {mean[name]:.9g}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def parse_prometheus(path: str) -> dict:
    """Parse a Prometheus textfile back to {metric_name: value} /
    {metric_name{labels}: value} floats — the CI smoke's format check."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    assert out, f"no samples parsed from {path}"
    return out
