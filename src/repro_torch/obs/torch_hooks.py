"""torch runtime observability: kernel builds, shape buckets, device gauges.

The port's counterpart of the reference's ``obs/jax_hooks.py``, with the
same four surfaces. torch compiles nothing per shape, so what stands in for
jax's compile events and jit caches is what the port does build and cache:

- :func:`install` — registers a listener on the kernel build module
  (:mod:`repro_torch.kernels._build`) feeding
  ``torch_kernel_builds_total{kernel}`` /
  ``torch_kernel_build_seconds_total{kernel}`` (and a histogram): one
  event per ``nvcc`` run at a kernel's first use, the compile side of the
  compile-vs-execute split.
- :func:`bucket_cache_entries` — the distinct ``(Npad, Tp)`` shape buckets
  the torch fan-out has run in this process
  (:func:`repro_torch.core.greedy_torch.buckets_run`) and the count of
  loaded kernel libraries. The per-bucket miss *deltas* are recorded at
  the launch site in ``core/portfolio.py`` (``torch_bucket_misses_total``);
  this probe is the absolute snapshot.
- :func:`update_device_gauges` — ``torch.cuda.memory_allocated``,
  ``memory_reserved`` and ``max_memory_allocated`` per CUDA device;
  nothing is recorded on a host without CUDA.
- :func:`snapshot` — one-call summary.

Every probe degrades to an absent metric; none wraps the solve path or a
kernel launch, so their errors always reach the caller.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .metrics import MetricsRegistry

__all__ = ["install", "installed", "bucket_cache_entries",
           "update_device_gauges", "snapshot"]

_install_lock = threading.Lock()
_installed_registry: Optional[MetricsRegistry] = None

_MEMORY_STATS = ("memory_allocated", "memory_reserved",
                 "max_memory_allocated")


def installed() -> bool:
    return _installed_registry is not None


def install(registry: MetricsRegistry) -> bool:
    """Register a kernel-build listener feeding ``registry``.

    Idempotent; only the first registry wins (as in the reference, whose
    jax listeners cannot be deregistered). Returns True when the hooks are
    (already) live.
    """
    global _installed_registry
    with _install_lock:
        if _installed_registry is not None:
            return True
        from repro_torch.kernels import _build

        builds = registry.counter(
            "torch_kernel_builds_total",
            "nvcc builds of the port's CUDA kernels, by kernel",
            labels=("kernel",))
        seconds = registry.counter(
            "torch_kernel_build_seconds_total",
            "cumulative seconds spent in nvcc builds, by kernel",
            labels=("kernel",))
        hist = registry.histogram(
            "torch_kernel_build_seconds",
            "distribution of per-build nvcc durations",
            labels=("kernel",))

        def _on_build(name: str, duration: float) -> None:
            try:
                builds.inc(kernel=name)
                seconds.inc(duration, kernel=name)
                hist.observe(duration, kernel=name)
            except Exception:
                pass

        _build.add_build_listener(_on_build)
        _installed_registry = registry
        return True


def bucket_cache_entries() -> Dict[str, int]:
    """Sizes of what the torch engine has cached in this process.

    Keys: ``greedy.buckets`` (distinct padded ``(Npad, Tp)`` fan-out
    buckets run) and ``kernels.loaded`` (built kernel libraries loaded).
    """
    out: Dict[str, int] = {}
    try:
        from repro_torch.core import greedy_torch
        out["greedy.buckets"] = len(greedy_torch.buckets_run())
    except Exception:
        pass
    try:
        from repro_torch.kernels import _build
        out["kernels.loaded"] = len(_build._LIBS)
    except Exception:
        pass
    return out


def update_device_gauges(registry: MetricsRegistry) -> Dict[str, float]:
    """Refresh best-effort device gauges; returns what was recorded."""
    recorded: Dict[str, float] = {}
    try:
        import torch
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    except Exception:
        n_dev = 0
    if n_dev:
        mem = registry.gauge("torch_device_memory_bytes",
                             "torch.cuda memory statistics per device",
                             labels=("device", "stat"))
        for d in range(n_dev):
            for key in _MEMORY_STATS:
                try:
                    val = float(getattr(torch.cuda, key)(d))
                except Exception:
                    continue
                mem.set(val, device=str(d), stat=key)
                recorded[f"{d}.{key}"] = val
    cache = registry.gauge("torch_bucket_cache_entries",
                           "shape buckets and kernel libraries cached by "
                           "the torch engine", labels=("fn",))
    for name, size in bucket_cache_entries().items():
        cache.set(float(size), fn=name)
        recorded[f"bucket.{name}"] = float(size)
    return recorded


def snapshot(registry: MetricsRegistry) -> Dict[str, Any]:
    """One-call summary: the reference's keys with ``jit`` read as
    ``bucket``, and the CUDA memory gauges (the counterpart of jax's live
    array count) under ``device_memory``."""
    recorded = update_device_gauges(registry)
    build_events = 0.0
    build_seconds = 0.0
    m = registry.get("torch_kernel_builds_total")
    if m is not None:
        build_events = m.total()
    m = registry.get("torch_kernel_build_seconds_total")
    if m is not None:
        build_seconds = m.total()
    return {
        "hooks_installed": installed(),
        "compile_events": build_events,
        "compile_seconds": round(build_seconds, 6),
        "bucket_cache_entries": bucket_cache_entries(),
        "device_memory": {k: v for k, v in recorded.items()
                          if not k.startswith("bucket.")},
    }
