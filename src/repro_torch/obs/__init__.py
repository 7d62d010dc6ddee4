"""Host-side tracing (counterpart of ``repro.obs``' ``trace``): spans and
events around snapshot I/O and draw-bank refreshes. The in-loop telemetry
and its exporters are not ported (ROADMAP item 12)."""
from repro_torch.obs import trace
from repro_torch.obs.trace import (Tracer, configure, enabled, event,
                                   read_jsonl, span)

__all__ = ["trace", "Tracer", "configure", "span", "event", "enabled",
           "read_jsonl"]
