"""Observability (counterpart of ``repro.obs``): per-round sampler
telemetry and host-side tracing.

Two complementary views of a run:

  * ``Telemetry`` / ``MetricsFrame`` (``repro_torch.obs.telemetry``) —
    DEVICE facts: per-round per-chain metric rows computed by the
    engine's round loop (grad/drift/conducive norms, noise scale,
    participation, wire bytes, health words). Telemetry-on runs are
    bitwise the telemetry-off runs: the probe draws from a generator of
    its own.
  * ``trace`` (``repro_torch.obs.trace``) — HOST facts: monotonic-clock
    spans and structured events (JSONL sink, optional
    ``torch.profiler`` ranges) around engine segments, streamed-window
    staging, snapshot I/O, draw-bank refresh, and serving
    prefill/decode.

``exporters`` surfaces frames as JSONL and Prometheus textfiles for the
``train --metrics-dir`` CLI; the formats are the reference's.
"""
from repro_torch.obs import trace
from repro_torch.obs.exporters import (parse_prometheus, read_metrics_jsonl,
                                       write_metrics_jsonl, write_prometheus)
from repro_torch.obs.telemetry import (TELEMETRY_PROBE_SALT, MetricsFrame,
                                       Telemetry)
from repro_torch.obs.trace import (Tracer, configure, enabled, event,
                                   read_jsonl, span)

__all__ = [
    "Telemetry", "MetricsFrame", "TELEMETRY_PROBE_SALT", "trace",
    "write_metrics_jsonl", "read_metrics_jsonl", "write_prometheus",
    "parse_prometheus", "Tracer", "configure", "span", "event", "enabled",
    "read_jsonl",
]
