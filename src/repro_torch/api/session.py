"""Async rolling-horizon replanning: plan window k+1 while k executes.

The port of the reference's ``api/session.py``. Execution proceeds in
fixed *windows*; each window is planned against that window's forecast
(an ensemble slice of a long forecast — see
:func:`repro_torch.api.request.window_profile` — or any per-window profile
source). All windows share the instances' horizon, so every window reuses
the same cached :class:`~repro_torch.core.portfolio.PreparedGraph`
(overlay-only replanning). The background worker plans on the planner's
own device (``Planner.device``), and its kernels launch on that thread's
current stream.

:meth:`PlanningSession.plan_for` returns window k's :class:`PlanResult`
and *prefetches* windows k+1..k+lookahead on a background worker, so by
the time window k finishes executing, window k+1's plan is (typically)
already done. Plans are deterministic: the session's results are
bit-identical to planning each window eagerly on the caller's thread
(tested).
"""
from __future__ import annotations

import concurrent.futures as _fut

from repro_torch import obs
from repro_torch.api.request import PlanRequest
from repro_torch.core.cancel import Cancelled, CancelToken

_WINDOW_FETCH = obs.registry().counter(
    "session_window_fetch_total",
    "plan_for() outcomes: prefetched = plan already done, waited = the "
    "caller blocked on the background worker", labels=("outcome",))


class PlanningSession:
    """Rolling-horizon planning over a
    :class:`~repro_torch.api.planner.Planner`.

    Args:
      planner: the shared facade (its graph cache is what makes
        per-window replanning cheap).
      instances: one instance or a sequence (the fleet being replanned).
      window_profiles: the per-window forecast source — a callable
        ``k -> profiles`` (one profile or an ensemble, any spelling
        :class:`PlanRequest` accepts) or a pre-built sequence indexed by
        window (its length bounds the session).
      n_windows: optional window count (required for callables that never
        exhaust; a sequence source defaults to its length).
      variants / robust: forwarded into each window's request.
      lookahead: how many future windows to keep in flight (default 1 =
        plan k+1 while k executes).

    All planning runs on ONE background worker, so concurrent plan calls
    never race on the planner's caches; the caller only blocks in
    :meth:`plan_for` when a window's plan is not ready yet.
    """

    def __init__(self, planner, instances, window_profiles,
                 n_windows: int | None = None, variants=None,
                 robust: bool = True, lookahead: int = 1):
        if callable(window_profiles):
            if n_windows is None:
                raise ValueError("n_windows is required with a callable "
                                 "window_profiles source")
            self._source = window_profiles
        else:
            seq = list(window_profiles)
            if n_windows is None:
                n_windows = len(seq)
            elif n_windows > len(seq):
                raise ValueError("n_windows exceeds the profile sequence")
            self._source = seq.__getitem__
        self.planner = planner
        self.instances = instances
        self.n_windows = int(n_windows)
        self.variants = variants
        self.robust = robust
        self.lookahead = max(int(lookahead), 0)
        self._pool = _fut.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="planning-session")
        self._plans: dict[int, _fut.Future] = {}
        self._tokens: dict[int, CancelToken] = {}
        self._retried: set[int] = set()
        self._closed = False

    def request_for(self, window: int) -> PlanRequest:
        """The :class:`PlanRequest` window ``window`` plans against."""
        return PlanRequest(instances=self.instances,
                           profiles=self._source(window),
                           variants=self.variants, robust=self.robust)

    def _submit(self, window: int) -> None:
        if (0 <= window < self.n_windows and window not in self._plans
                and not self._closed):
            # each window's plan carries its own CancelToken so close()
            # can stop the ONE in-flight solve, not just the queue
            token = CancelToken()
            self._tokens[window] = token

            def _plan(window=window, token=token,
                      parent=obs.current_span()):
                # re-anchor the worker thread to the caller's span (the
                # context variable does not cross pool submission)
                with obs.attach(parent):
                    with obs.span("session_window", window=window):
                        return self.planner.plan(self.request_for(window),
                                                 cancel=token)

            self._plans[window] = self._pool.submit(_plan)

    def plan_for(self, window: int):
        """Window ``window``'s :class:`PlanResult`; blocks only when its
        background plan has not finished. Prefetches the next
        ``lookahead`` windows before blocking, so planning overlaps the
        caller's execution of the current window.

        A failed background plan is NOT cached forever: its future is
        evicted and the window resubmitted once (a transient failure —
        a device hiccup, an injected fault — heals on retry); only a
        second failure propagates, and later calls re-raise it instead
        of looping."""
        if self._closed:
            raise RuntimeError("planning session is closed")
        if not 0 <= window < self.n_windows:
            raise IndexError(f"window {window} outside "
                             f"[0, {self.n_windows})")
        self._submit(window)
        for nxt in range(window + 1, window + 1 + self.lookahead):
            self._submit(nxt)
        _WINDOW_FETCH.inc(outcome="prefetched"
                          if self._plans[window].done() else "waited")
        try:
            return self._plans[window].result()
        except (_fut.CancelledError, Cancelled):
            raise RuntimeError("planning session is closed") from None
        except Exception:
            if window in self._retried or self._closed:
                raise
            self._retried.add(window)
            del self._plans[window]
            self._tokens.pop(window, None)
            self._submit(window)
            return self._plans[window].result()

    def windows(self):
        """Iterate ``(window, PlanResult)`` over the whole session."""
        for k in range(self.n_windows):
            yield k, self.plan_for(k)

    def close(self) -> None:
        """Close the session without draining the lookahead: queued
        prefetch plans are cancelled (``cancel_futures``) AND the one
        in-flight plan (if any) is cancelled through its
        :class:`~repro_torch.core.cancel.CancelToken`, so closing mid-run
        returns within one solver chunk instead of waiting for the
        in-flight window to plan to completion first."""
        self._closed = True
        for token in self._tokens.values():
            token.cancel("session closed")
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
