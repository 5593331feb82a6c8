"""Cooperative cancellation for long-running solves.

A :class:`CancelToken` is threaded from the caller down into every solver
layer, and the layers poll it at their natural chunk boundaries:

* :mod:`repro_torch.core.solvers` — between grid cells (every per-cell
  solver) and between the exact solver's per-instance dispatches;
* :mod:`repro_torch.core.ilp` — before each HiGHS solve and between its
  row families; the solve itself is bounded by the token's deadline
  (scipy's ``milp`` exposes no interrupt callback, so the deadline-clamped
  ``time_limit`` is the interrupt surface for one in-flight MILP);
* :mod:`repro_torch.core.portfolio` — between greedy cells / device bucket
  launches and before each local-search climb;
* :mod:`repro_torch.core.local_search_torch` — before the device climb and
  between its rounds, and between sequential polish rounds.

Every poll increments :attr:`CancelToken.checks`, so tests can assert
cancellation is real — a cancelled solve observed the token and stopped,
rather than running to completion unobserved.

Tokens are cheap, thread-safe, and single-shot: once cancelled they stay
cancelled. ``deadline`` (a ``time.monotonic()`` timestamp) makes a token
self-expiring — :meth:`check` raises once the deadline passes even if
nobody called :meth:`cancel` — which is how a wall-clock budget reaches
solver layers that only ever see the token.
"""
from __future__ import annotations

import threading
import time

from repro_torch import obs

# How long a cancelled solve keeps running before a poll point notices:
# observed once per cancellation, on the (rare) raising path of check().
_CANCEL_LATENCY = obs.registry().histogram(
    "cancel_observe_latency_seconds",
    "delay between CancelToken.cancel() and the poll that observed it",
    reservoir=256)


class Cancelled(Exception):
    """Raised by :meth:`CancelToken.check` inside a cancelled solve.

    Deliberately NOT a :class:`RuntimeError` subclass: retry/backoff
    handlers for transient faults must never catch a cancellation (a
    cancelled solve is *done*, not degraded)."""


class CancelToken:
    """One cancellable scope: a flag, an optional deadline, and counters.

    Args:
      deadline: optional ``time.monotonic()`` timestamp after which
        :meth:`check` raises on its own (the wall-clock budget spelling).

    Attributes:
      checks: how many times a solver layer polled this token — the
        "cancellation is real" observability counter.
      reason: why the token was cancelled (None while live).
    """

    __slots__ = ("deadline", "checks", "reason", "_cancelled", "_lock",
                 "cancelled_at", "_latency_done")

    def __init__(self, deadline: float | None = None):
        self.deadline = deadline
        self.checks = 0
        self.reason: str | None = None
        self._cancelled = False
        self._lock = threading.Lock()
        self.cancelled_at: float | None = None
        self._latency_done = False

    @classmethod
    def with_budget(cls, budget: float | None) -> "CancelToken":
        """A token expiring ``budget`` seconds from now (None = never)."""
        return cls(None if budget is None else time.monotonic() + budget)

    def cancel(self, reason: str = "cancelled") -> bool:
        """Cancel the scope; returns False if it already was cancelled."""
        with self._lock:
            if self._cancelled:
                return False
            self._cancelled = True
            self.reason = reason
            self.cancelled_at = time.monotonic()
            return True

    @property
    def cancelled(self) -> bool:
        """True once :meth:`cancel` fired or the deadline passed."""
        if self._cancelled:
            return True
        if self.deadline is not None and time.monotonic() >= self.deadline:
            self.cancel("deadline expired")
            return True
        return False

    def remaining(self) -> float | None:
        """Seconds until the deadline (None = no deadline)."""
        return None if self.deadline is None \
            else self.deadline - time.monotonic()

    def check(self) -> None:
        """Poll point: count the observation, raise if cancelled.

        Solver layers call this at chunk boundaries; it is the ONLY way a
        solve learns it was cancelled, so every layer's loop must reach a
        ``check()`` within one chunk of work.
        """
        self.checks += 1        # benign race: a lost increment only
        # undercounts telemetry, never correctness
        if self.cancelled:
            # rare path: record cancel -> observation latency once
            if not self._latency_done and self.cancelled_at is not None:
                self._latency_done = True
                _CANCEL_LATENCY.observe(time.monotonic() - self.cancelled_at)
            raise Cancelled(self.reason or "cancelled")


def checkpoint(cancel: "CancelToken | None") -> None:
    """``cancel.check()`` tolerating ``None`` — the call sites' spelling
    (every solver-layer ``cancel=`` parameter defaults to None)."""
    if cancel is not None:
        cancel.check()
