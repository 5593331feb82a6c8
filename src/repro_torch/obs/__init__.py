"""Observability facade of the port: tracing, metrics, torch runtime hooks.

The port of the reference's ``obs`` package: ``metrics`` and ``trace`` are
copies, ``torch_hooks`` takes the place of its ``jax_hooks``.

Usage (hot paths import this module once and call the module-level
helpers; the disabled path costs one attribute check):

    from repro_torch import obs

    with obs.span("plan", solver="heuristic"):
        ...

    obs.registry().counter("plans_total").inc()

Tracing is off by default: ``obs.span(...)`` returns the inert
:data:`NULL_SPAN` singleton until a :class:`Tracer` is installed with
:func:`set_tracer` (or :func:`configure`). Metrics are always on —
registry updates are a dict update under a per-metric lock — while
*core-layer* metrics live in the process-global registry returned by
:func:`registry`; a component that must not cross-count with others
owns a :class:`MetricsRegistry` of its own (render several with
:func:`render_prometheus`).
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Tuple

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      render_prometheus)
from .trace import NULL_SPAN, NullSpan, Span, Tracer, span_tree
from . import torch_hooks

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "render_prometheus", "NULL_SPAN", "NullSpan", "Span", "Tracer",
    "span_tree", "torch_hooks",
    "tracer", "set_tracer", "registry", "set_registry", "configure",
    "span", "start_span", "attach", "current_span",
]

_tracer: Optional[Tracer] = None
_registry: MetricsRegistry = MetricsRegistry()


# -- tracer management ----------------------------------------------------

def tracer() -> Optional[Tracer]:
    """The active tracer, or None when tracing is disabled."""
    return _tracer


def set_tracer(t: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or, with None, disable) the process-global tracer."""
    global _tracer
    prev, _tracer = _tracer, t
    return prev


def registry() -> MetricsRegistry:
    """The process-global metrics registry (core/solver layer metrics)."""
    return _registry


def set_registry(r: MetricsRegistry) -> MetricsRegistry:
    global _registry
    prev, _registry = _registry, r
    return prev


def configure(tracing: bool = True, torch_hooks_on: bool = False,
              max_finished: int = 65536
              ) -> Tuple[Optional[Tracer], MetricsRegistry]:
    """One-call setup: fresh tracer (optional) + torch runtime hooks."""
    t = Tracer(max_finished=max_finished) if tracing else None
    set_tracer(t)
    if torch_hooks_on:
        torch_hooks.install(_registry)
    return t, _registry


# -- hot-path span helpers ------------------------------------------------
# The disabled path must cost nothing measurable: one global read, one
# identity check, return a shared singleton. No allocation, no locks.

def span(name: str, parent: Optional[Span] = None, **attrs: Any):
    """Start a span for use as a context manager (NULL_SPAN when off)."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, parent=parent, **attrs)


def start_span(name: str, parent: Optional[Span] = None, **attrs: Any):
    """Start a span to be end()-ed explicitly (NULL_SPAN when off)."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.start(name, parent=parent, **attrs)


def attach(span: Optional[Span]):
    """Re-anchor implicit parenting to ``span`` on this thread."""
    t = _tracer
    if t is None or span is None or not span:
        return contextlib.nullcontext()
    return t.attach(span)


def current_span() -> Optional[Span]:
    t = _tracer
    return t.current() if t is not None else None
