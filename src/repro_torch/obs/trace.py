"""Structured tracing: spans with parent links, exported as JSONL (a copy
of the reference's ``obs/trace.py``; framework-free).

A :class:`Span` is a named, timed interval with attributes and an
optional parent; a :class:`Tracer` collects finished spans in a bounded
buffer and can render them as Chrome ``trace_event``-compatible JSONL
(one JSON object per line, loadable with ``json.loads`` line by line,
or pasted into ``chrome://tracing`` / Perfetto after wrapping in
``[...]``).

Parenting is implicit within a thread via a ``contextvars`` context
variable (``with tracer.span("child"):`` nests under the enclosing
span) and explicit across threads: pass ``parent=`` or re-anchor a
worker thread with ``with tracer.attach(span):``.

Hot-path contract: when tracing is disabled the module-level facade in
``repro_torch.obs`` returns the singleton :data:`NULL_SPAN`, whose every
method is a constant no-op — no locks, no allocation beyond the call
itself. The enabled path takes one small lock per span start/end (never
per attribute set), which is fine: an enabled tracer is an explicit
opt-in.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional

__all__ = ["Span", "NullSpan", "NULL_SPAN", "Tracer", "span_tree"]

_ids = itertools.count(1)
_current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("repro_torch_obs_current_span", default=None)


class Span:
    """One timed interval. Use as a context manager or end() explicitly."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id", "attrs",
                 "t0", "t1", "tid", "_tracer", "_token")

    def __init__(self, name: str, tracer: "Tracer",
                 parent: Optional["Span"] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.span_id = next(_ids)
        if parent is not None and parent.span_id:
            self.parent_id = parent.span_id
            self.trace_id = parent.trace_id
        else:
            self.parent_id = 0
            self.trace_id = self.span_id
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.tid = threading.get_ident()
        self._tracer = tracer
        self._token = None

    # -- recording ---------------------------------------------------
    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, **attrs: Any) -> None:
        """Finish the span (idempotent; later calls are no-ops)."""
        if self.t1 is not None:
            return
        if attrs:
            self.attrs.update(attrs)
        self.t1 = time.perf_counter()
        self._tracer._finish(self)

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0

    # -- context manager: makes self the implicit parent -------------
    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        if exc_type is not None and "error" not in self.attrs:
            self.attrs["error"] = exc_type.__name__
        self.end()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "open" if self.t1 is None else f"{self.duration * 1e3:.2f}ms"
        return f"Span({self.name!r}, id={self.span_id}, {state})"


class NullSpan:
    """Inert span: every operation is a constant-time no-op."""

    __slots__ = ()
    name = ""
    span_id = 0
    parent_id = 0
    trace_id = 0
    t0 = 0.0
    t1 = 0.0
    tid = 0
    attrs: Dict[str, Any] = {}
    duration = 0.0

    def set(self, **attrs: Any) -> "NullSpan":
        return self

    def end(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:  # pragma: no cover
        return "NULL_SPAN"


NULL_SPAN = NullSpan()


class Tracer:
    """Collects spans; bounded buffer of finished spans, JSONL export."""

    def __init__(self, max_finished: int = 65536):
        self._finished: Deque[Span] = deque(maxlen=max_finished)
        self._open: Dict[int, Span] = {}
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self.enabled = True

    # -- span creation -----------------------------------------------
    def start(self, name: str, parent: Optional[Span] = None,
              **attrs: Any) -> Span:
        """Start a span without entering it (end() it explicitly)."""
        if parent is None:
            parent = _current_span.get()
        elif not parent:          # NULL_SPAN passed through from a caller
            parent = None
        sp = Span(name, self, parent=parent, attrs=attrs)
        with self._lock:
            self._open[sp.span_id] = sp
        return sp

    def span(self, name: str, parent: Optional[Span] = None,
             **attrs: Any) -> Span:
        """Start a span to be used as a context manager."""
        return self.start(name, parent=parent, **attrs)

    @contextlib.contextmanager
    def attach(self, span: Optional[Span]) -> Iterator[None]:
        """Make ``span`` the implicit parent on *this* thread.

        Context variables do not propagate across thread-pool submission,
        so worker threads re-anchor explicitly:
        ``with tracer.attach(rung_span): ...``.
        """
        if span is None or not span:
            yield
            return
        token = _current_span.set(span)
        try:
            yield
        finally:
            _current_span.reset(token)

    def current(self) -> Optional[Span]:
        return _current_span.get()

    def _finish(self, span: Span) -> None:
        with self._lock:
            self._open.pop(span.span_id, None)
            self._finished.append(span)

    # -- inspection ---------------------------------------------------
    def finished(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def open_spans(self) -> List[Span]:
        with self._lock:
            return list(self._open.values())

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()
            self._open.clear()

    def tree(self, trace_id: Optional[int] = None) -> List[Dict[str, Any]]:
        """Nested ``{name, attrs, duration_ms, children}`` dicts.

        With ``trace_id=None`` returns a forest of every root span seen.
        """
        spans = self.finished()
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return span_tree(spans)

    # -- export -------------------------------------------------------
    def to_events(self) -> List[Dict[str, Any]]:
        """Finished spans as Chrome ``trace_event`` complete events."""
        out = []
        for s in self.finished():
            args = dict(s.attrs)
            args["span_id"] = s.span_id
            args["trace_id"] = s.trace_id
            if s.parent_id:
                args["parent_id"] = s.parent_id
            out.append({
                "name": s.name,
                "cat": "repro_torch",
                "ph": "X",
                "ts": (s.t0 - self._epoch) * 1e6,
                "dur": ((s.t1 or s.t0) - s.t0) * 1e6,
                "pid": 0,
                "tid": s.tid,
                "args": args,
            })
        return out

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(ev, default=str)
                         for ev in self.to_events())

    def dump_jsonl(self, path: str) -> int:
        """Write one trace_event JSON object per line; returns #events."""
        events = self.to_events()
        with open(path, "w") as fh:
            for ev in events:
                fh.write(json.dumps(ev, default=str))
                fh.write("\n")
        return len(events)


def span_tree(spans: List[Span]) -> List[Dict[str, Any]]:
    """Arrange finished spans into parent->children nests (roots first)."""
    nodes = {s.span_id: {"name": s.name, "attrs": dict(s.attrs),
                         "duration_ms": round(s.duration * 1e3, 3),
                         "children": []}
             for s in spans}
    roots: List[Dict[str, Any]] = []
    for s in sorted(spans, key=lambda s: s.t0):
        node = nodes[s.span_id]
        parent = nodes.get(s.parent_id)
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots
