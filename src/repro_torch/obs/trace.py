"""Host-side tracing: monotonic-clock spans + structured events, JSONL
(counterpart of ``repro.obs.trace``).

The sampler's host loop, snapshot I/O, draw-bank refreshes and serving
are what this module makes visible. One module-level tracer (disabled by
default: every call is a no-op on a shared null object, so instrumented
code paths cost nothing when nobody is watching), configured once per
process by the entry points::

    from repro_torch.obs import trace
    trace.configure(path="run/trace.jsonl", echo=True)
    with trace.span("snapshot.save", round=8):
        ...
    trace.event("snapshot.corrupt", path=p)

Span lines carry the WALL-clock start (``ts``, epoch seconds, for
cross-process alignment) and a MONOTONIC duration (``dur_s``, immune to
clock steps), plus the nesting ``depth`` and ``parent`` span name from a
thread-local stack, so a reader can rebuild the span tree from the flat
JSONL. ``echo=True`` also prints one compact line per record.
``profiler=True`` wraps every span in a
``torch.profiler.record_function`` range, so host spans line up with
device work in a ``torch.profiler`` trace.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "attrs", "t0", "ts", "depth", "parent",
                 "_prof")

    def __init__(self, tracer, name, attrs):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self._prof = None

    def __enter__(self):
        tls = self.tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        self.depth = len(stack)
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.ts = time.time()
        self.t0 = time.monotonic()
        if self.tracer.profiler:
            import torch
            self._prof = torch.profiler.record_function(self.name)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        dur = time.monotonic() - self.t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
        self.tracer._tls.stack.pop()
        rec = {"type": "span", "name": self.name, "ts": self.ts,
               "dur_s": dur, "depth": self.depth, "parent": self.parent}
        rec.update(self.attrs)
        self.tracer._emit(rec)
        return False


class Tracer:
    """A span/event sink. ``path=None`` and ``echo=False`` disables it
    entirely (``span`` returns a shared no-op context manager)."""

    def __init__(self, path: Optional[str] = None, *, echo: bool = False,
                 profiler: bool = False):
        self.path = path
        self.echo = echo
        self.profiler = profiler
        self._fh = None
        self._lock = threading.Lock()
        self._tls = threading.local()

    @property
    def enabled(self) -> bool:
        return self.path is not None or self.echo

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs):
        if not self.enabled:
            return
        stack = getattr(self._tls, "stack", [])
        rec = {"type": "event", "name": name, "ts": time.time(),
               "depth": len(stack),
               "parent": stack[-1] if stack else None}
        rec.update(attrs)
        self._emit(rec)

    def _emit(self, rec: dict):
        line = json.dumps(rec, default=str)
        with self._lock:
            if self.path is not None:
                if self._fh is None:
                    self._fh = open(self.path, "a")
                self._fh.write(line + "\n")
                self._fh.flush()
            if self.echo:
                ts = time.strftime("%H:%M:%S", time.localtime(rec["ts"]))
                kv = " ".join(
                    f"{k}={rec[k]}" for k in rec
                    if k not in ("type", "name", "ts", "depth", "parent"))
                print(f"[{ts}] {rec['name']} {kv}".rstrip(), flush=True)

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_TRACER = Tracer()


def configure(path: Optional[str] = None, *, echo: bool = False,
              profiler: bool = False) -> Tracer:
    """Install the process-wide tracer (and return it). Call with no
    arguments to disable tracing again."""
    global _TRACER
    _TRACER.close()
    _TRACER = Tracer(path, echo=echo, profiler=profiler)
    return _TRACER


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **attrs):
    """Context manager timing one named host-side segment."""
    return _TRACER.span(name, **attrs)


def event(name: str, **attrs):
    """One timestamped structured log line (no duration)."""
    _TRACER.event(name, **attrs)


def read_jsonl(path: str) -> list:
    """Parse a trace JSONL file back into a list of record dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
