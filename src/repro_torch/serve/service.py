"""Supervised multi-worker planning service over a shared :class:`Planner`.

The port of ``repro.serve.service``: the same admission, coalescing,
supervision, fallback ladder, journal and fault seam, over the port's
:class:`~repro_torch.api.planner.Planner`, which plans on the card unless
it was given ``device="cpu"``. Three things differ from the reference, each
for the card:

* a real CUDA out-of-memory (``torch.OutOfMemoryError``, which is a
  ``RuntimeError``, not a ``MemoryError``) takes the blocked-LP retry as an
  injected or host ``MemoryError`` does, after the CUDA caching allocator
  has returned its free blocks (``torch.cuda.empty_cache``); the retry
  stays on the same device;
* ``compilation_cache=True`` builds the planner's CUDA kernels at startup
  (:func:`repro_torch.kernels.backend.enable_compilation_cache`) and lets
  a build failure raise, where the reference swallows every error of its
  jax cache hook: a kernel that does not build must not hide behind the
  fallback ladder;
* every rung stays on the planner's device. The ``numpy``-engine rungs
  (``exact``, ``ilp``, ``dp``, ``asap``) run on the host, as they do in
  the reference.

The paper's own structure
provides a graceful-degradation ladder — the certified exact oracles,
the 17-variant heuristic portfolio, and the §5.1 ``asap`` baseline all
serve the same ``(instances x profiles)`` grid shape — so a serving tier
can *always* emit some feasible schedule before the deadline.
:class:`PlanService` wires that ladder behind a supervised worker pool:

* **Priority admission + coalescing** — :meth:`PlanService.submit`
  validates the request, rejects with a structured :class:`Overloaded`
  error when the queue is full, and enqueues a :class:`Ticket` on a
  deadline-earliest-first priority heap. Budget-less tickets are aged:
  each gets a *virtual* deadline ``admitted + aging`` seconds out, so a
  ticket without a budget outranks every ticket submitted more than
  ``aging`` seconds after it — urgent work jumps the queue, but nothing
  starves. Drain workers claim the earliest-deadline ticket plus
  compatible queue-mates (same solver, engine, variant tuple, profile
  count, robust mode) into one combined-grid ``Planner.plan`` launch;
  per-cell results are bit-identical to solo plans, so coalescing — and
  the worker count — is invisible to callers: fault-free service results
  equal direct ``Planner.plan``, bit for bit.

* **Supervised workers** — ``workers=N`` drain workers serve distinct
  coalesce groups concurrently, each on its own per-engine
  :meth:`Planner.clone` (clone caches are private, so workers never race
  on a ``PreparedGraph``). A supervisor thread watches per-worker
  heartbeats: a dead worker thread (an escaped exception) or a wedged
  one (claimed tickets, no heartbeat for ``heartbeat_timeout``) is
  deposed — its generation is bumped so the stale thread self-exits at
  the next checkpoint, its in-flight solve is cancelled through the
  stage token, its unresolved tickets are requeued, and a fresh thread
  takes the slot.

* **Cooperative cancellation** — every chain-stage solve carries a
  :class:`repro_torch.core.cancel.CancelToken` threaded through
  ``Planner.plan`` into the solver layers, which poll it at their chunk
  boundaries (heuristic chain rungs, ILP matrix assembly, greedy bucket
  launches, local-search commit rounds). A watchdog timeout, a deposed
  worker, or a caller's :meth:`Ticket.cancel` therefore *stops* the
  solve within one rung budget and releases its pool worker — abandoned
  threads no longer run to completion in the background. Tokens also
  self-expire at the batch's deadline, so a wedged-but-polling solve
  times itself out even if the watchdog thread is gone.

* **Deadline budgets + fallback chain** — every ticket carries a
  wall-clock budget; the watchdog bounds each chain-stage solve by the
  minimum remaining budget in the batch and, on timeout or failure,
  walks ``exact -> ilp (time-limited) -> heuristic -> asap``. ILP stages
  get a default ``time_limit`` clamped to the remaining budget, and a
  time-limit exit with an incumbent is a *degraded success*: the
  schedule ships with its HiGHS ``lower_bound``/``mip_gap`` certificate.
  The terminal ``asap`` stage runs untimed (it is O(N + E)), so even a
  blown budget still yields a feasible schedule. Results record
  ``degraded``, ``fallback_stage``, and the full ``attempts`` log on the
  :class:`~repro_torch.api.result.PlanResult`.

* **Write-ahead ticket journal** — with ``journal_dir=`` set, every
  admitted ticket is persisted (:mod:`repro_torch.serve.journal`) *before* it
  becomes claimable and erased when its future resolves. A service that
  dies mid-burst (a real crash, or the chaos seam's
  :meth:`PlanService.kill`) leaves exactly the admitted-but-unfinished
  set on disk; constructing a new service on the same ``journal_dir``
  replays those tickets into the queue (``service.replayed``) with
  at-least-once semantics — no admitted ticket is ever lost.

* **Retry + blocked-LP recovery** — transient failures
  (:class:`~repro_torch.runtime.fault.SimulatedFailure`) retry with
  exponential backoff; a ``MemoryError`` or a CUDA
  ``torch.OutOfMemoryError`` retries once on a planner clone with a
  reduced ``lp_budget_bytes`` so the blocked longest-path form serves the
  request instead.

* **Validation + quarantine** — malformed instances/profiles are
  rejected at admission (:func:`repro_torch.api.request.validate_resolved`)
  or, if corruption appears later, quarantined at batch assembly with a
  structured :class:`InvalidRequest`. If a combined solve still dies on
  an unexpected error, the batch is bisected: every ticket re-runs its
  chain in isolation, so exactly the poisoned ticket fails.

* **Fault seam + telemetry** — a
  :class:`~repro_torch.runtime.fault.ServiceFaultInjector` fires deterministic
  solver crashes, hangs, device OOMs, profile corruption, worker deaths,
  wedges, and mid-burst kills inside the real code paths;
  :meth:`PlanService.stats` reports queue depth, worker restarts,
  cancellation counters, coalesce ratio, and p50/p99 plan latency.
"""
from __future__ import annotations

import concurrent.futures as _fut
import heapq
import itertools
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.planner import Planner
from repro_torch.api.request import PlanRequest, validate_resolved
from repro_torch.api.result import PlanResult
from repro_torch.core.cancel import Cancelled, CancelToken
from repro_torch.kernels.backend import enable_compilation_cache, \
    resolve_engine
from repro_torch.runtime.fault import SimulatedFailure, corrupt_profile
from repro_torch.serve.journal import TicketJournal, decode_ticket, \
    encode_ticket

# The graceful-degradation ladder, per requested solver: every stage
# serves the same (instances x profiles) grid, each rung cheaper and more
# robust than the one above it; "asap" (O(N + E), no solver machinery)
# terminates every chain.
FALLBACK_CHAINS: dict[str, tuple[str, ...]] = {
    "exact": ("exact", "ilp", "heuristic", "asap"),
    "ilp": ("ilp", "heuristic", "asap"),
    "dp": ("dp", "heuristic", "asap"),
    "heuristic": ("heuristic", "asap"),
    "asap": ("asap",),
}

# Every event-style counter the service tracks; stats() reads these out
# of the per-service metrics registry under the same wire keys the
# pre-registry Counter dict used. inflight_solves and max_queue_depth
# are gauges and handled separately.
_STAT_EVENTS = (
    "submitted", "completed", "failed", "degraded", "rejected_overloaded",
    "rejected_invalid", "quarantined", "splits", "retries", "oom_retries",
    "timeouts", "cancelled", "cancelled_solves", "worker_restarts",
    "requeued", "replayed", "replay_corrupt", "replay_deferred",
    "priority_inversions", "cancel_checks", "batches",
    "coalesced_requests", "mapping_search_shrinks",
    "mapping_heft_downgrades")

# code -> class, filled by ServiceError.__init_subclass__ so
# ServiceError.from_dict can rebuild the exact subclass off the wire
_ERROR_TYPES: dict[str, type] = {}


def _wire(value):
    """JSON-safe twin of ``value``: tuples become lists, numpy scalars
    become python scalars, recursively — what ``to_dict`` promises."""
    if isinstance(value, dict):
        return {str(k): _wire(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_wire(v) for v in value]
    if isinstance(value, np.generic):
        return value.item()
    return value


class ServiceError(RuntimeError):
    """Structured service rejection: ``code`` + machine-readable details.

    ``to_dict()`` is the wire shape: plain JSON types only (``json.dumps``
    round-trips it), and :meth:`from_dict` rebuilds the matching
    subclass losslessly — ``from_dict(e.to_dict()).to_dict() ==
    e.to_dict()``. The message stays human-readable.
    """

    code = "error"

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _ERROR_TYPES[cls.code] = cls

    def __init__(self, message: str, **details):
        super().__init__(message)
        self.details = details

    def to_dict(self) -> dict:
        return {"code": self.code, "message": str(self),
                **_wire(self.details)}

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceError":
        d = dict(d)
        klass = _ERROR_TYPES.get(d.pop("code", "error"), ServiceError)
        return klass(d.pop("message", ""), **d)


_ERROR_TYPES[ServiceError.code] = ServiceError


class Overloaded(ServiceError):
    """Admission queue full — retry later / shed load upstream."""

    code = "overloaded"


class InvalidRequest(ServiceError):
    """Malformed instance/profile — rejected before touching shared
    state; never retried."""

    code = "invalid_request"


class PlanFailure(ServiceError):
    """Every chain stage failed (the request is poisoned or the service
    is badly degraded); ``details["attempts"]`` records the walk."""

    code = "plan_failure"


class ServiceClosed(ServiceError):
    """The service shut down before this ticket was served."""

    code = "closed"


class TicketCancelled(ServiceError):
    """The caller cancelled this ticket (:meth:`Ticket.cancel`) before
    it was served."""

    code = "cancelled"


def _try_resolve(fut: _fut.Future, result) -> bool:
    """Resolve ``fut`` if nobody beat us to it; True = this call won.

    Delivery, rejection, caller cancellation, and supervisor requeue can
    race on one ticket — each path routes through this (or
    :func:`_try_reject`) so every future resolves exactly once and the
    winner alone does the bookkeeping."""
    try:
        if not fut.set_running_or_notify_cancel():
            return False
        fut.set_result(result)
        return True
    except (RuntimeError, _fut.InvalidStateError):
        return False


def _try_reject(fut: _fut.Future, exc: Exception) -> bool:
    try:
        if not fut.set_running_or_notify_cancel():
            return False
        fut.set_exception(exc)
        return True
    except (RuntimeError, _fut.InvalidStateError):
        return False


def _swallow(fut: _fut.Future) -> None:
    """Done-callback for abandoned solve futures: consume the exception
    (the cancelled solve's ``Cancelled``) so the executor never logs it."""
    try:
        fut.exception()
    except _fut.CancelledError:
        pass


class Ticket:
    """One admitted request: a future plus its admission metadata.

    ``vdeadline`` is the priority-queue key: a ticket with a deadline
    budget sorts by its real deadline; a budget-less ticket gets the
    virtual deadline ``admitted + aging``, so it yields to urgent work
    submitted within ``aging`` seconds of it and outranks everything
    that arrives later — earliest-deadline-first with no starvation.
    """

    def __init__(self, request: PlanRequest, instances, grid, names,
                 engine: str, budget: float | None, aging: float = 30.0):
        self.request = request
        self.instances = instances            # resolved (crop applied)
        self.grid = grid
        self.names = names
        self.engine = engine
        self.solver = request.solver if request.solver else "heuristic"
        self.robust = bool(request.robust)
        self.options = request.solver_options
        self.mapping = request.mapping if request.mapping else "fixed"
        self.mapping_options = request.mapping_options
        self.admitted = time.monotonic()
        self.deadline = None if budget is None else self.admitted + budget
        self.vdeadline = self.deadline if self.deadline is not None \
            else self.admitted + float(aging)
        self.journal_seq: int | None = None
        self._fut: _fut.Future = _fut.Future()
        self._service: "PlanService | None" = None
        self._batch: "list[Ticket] | None" = None   # batch being served
        self._stage_token: CancelToken | None = None
        # tracing: the ticket's root "request" span and its "queue_wait"
        # child (NULL_SPAN unless a tracer was installed at admission)
        self.span = obs.NULL_SPAN
        self._wait_span = obs.NULL_SPAN

    @property
    def cells(self) -> int:
        return len(self.instances) * len(self.grid[0])

    def remaining(self) -> float | None:
        """Seconds left in this ticket's deadline budget (None = unbounded)."""
        return None if self.deadline is None \
            else self.deadline - time.monotonic()

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: float | None = None) -> PlanResult:
        """Block for the plan; raises the structured :class:`ServiceError`
        subclass on rejection/failure/cancellation."""
        return self._fut.result(timeout)

    def cancel(self, reason: str = "cancelled by caller") -> bool:
        """Cancel this ticket; True if the cancellation won (the ticket
        had not already resolved).

        Queued tickets simply never run (their journal entry is erased);
        a ticket inside an in-flight solve cancels that solve through
        its stage :class:`~repro_torch.core.cancel.CancelToken` once every
        batch-mate is also done — the solver polls the token at its next
        chunk boundary and the pool worker goes idle within one rung
        budget. ``result()`` then raises :class:`TicketCancelled`.
        """
        won = _try_reject(self._fut, TicketCancelled(
            f"ticket cancelled: {reason}", reason=reason))
        if won and self._service is not None:
            self._service._note_cancel(self)
        return won

    def _coalesce_key(self):
        try:
            opts = tuple(sorted((self.options or {}).items()))
            mopts = tuple(sorted((self.mapping_options or {}).items()))
        except TypeError:                      # unhashable option values:
            opts = object()                    # unique key, no coalescing
            mopts = ()
        return (self.solver, self.engine, self.names, len(self.grid[0]),
                self.robust, opts, self.mapping, mopts)


class _WorkerSlot:
    """Supervision record of one drain worker.

    ``generation`` is the depose handshake: the supervisor bumps it to
    retire a wedged thread; the thread checks it at every checkpoint
    (queue wait, watchdog poll, wedge stall) and self-exits on mismatch,
    so a stale worker can never deliver over its replacement."""

    __slots__ = ("index", "thread", "generation", "heartbeat", "current",
                 "token")

    def __init__(self, index: int):
        self.index = index
        self.thread: threading.Thread | None = None
        self.generation = 0
        self.heartbeat = time.monotonic()
        self.current: list[Ticket] | None = None
        self.token: CancelToken | None = None


class PlanService:
    """A long-lived, fault-tolerant planning frontend over one
    :class:`~repro_torch.api.planner.Planner`.

    Args:
      planner: the shared facade; the service clones it per resolved
        engine (so coalescing never flips an ``auto`` resolution) and for
        the reduced-budget blocked-LP retry. Its platform/k/ls/validate
        configuration applies to every clone.
      workers: drain-worker count — concurrent coalesce groups served at
        once. Fault-free results are bit-identical at any worker count.
      max_queue: admission bound — ``submit`` raises :class:`Overloaded`
        when this many tickets are already waiting.
      max_batch: coalescing bound — at most this many tickets share one
        combined-grid launch.
      default_budget: seconds of wall-clock deadline budget a ticket gets
        when ``submit`` does not specify one (None = unbounded).
      aging: seconds after which a budget-less ticket outranks newer
        arrivals (its virtual deadline; see :class:`Ticket`).
      heartbeat_timeout: seconds of heartbeat silence from a worker with
        claimed tickets before the supervisor deposes and replaces it.
      retries / backoff: transient-failure policy per chain stage
        (exponential: ``backoff * 2**attempt`` seconds between tries).
      ilp_time_limit: default HiGHS time limit (seconds) for ``ilp`` /
        ``exact`` chain stages reached through the service — clamped to
        the remaining deadline budget; an explicit
        ``solver_options["time_limit"]`` on the request wins.
      lp_retry_budget_bytes: the reduced ``lp_budget_bytes`` used for the
        one blocked-LP retry after a ``MemoryError`` or a CUDA
        ``torch.OutOfMemoryError``.
      fallback_variants: the (cheap) heuristic column set used when an
        exact chain degrades INTO the heuristic stage; heuristic-first
        requests keep their own variants.
      journal_dir: write-ahead ticket journal directory (None = no
        journal). Admitted-but-unfinished tickets found there at
        construction are replayed into the queue (``self.replayed``).
      journal_replay_cap: at most this many journal entries are replayed
        at construction (oldest first — admission order); entries past
        the cap stay on disk (``stats()["replay_deferred"]``) for a
        later restart, so a huge backlog cannot wedge startup. None =
        replay everything.
      compact_journal: renumber the journal to dense sequences at
        construction (:meth:`~repro_torch.serve.journal.TicketJournal
        .compact`) so long-lived journals do not grow sequence numbers
        without bound.
      registry: the per-service :class:`~repro_torch.obs.MetricsRegistry`
        backing :meth:`stats` and :meth:`metrics_text` (a private one is
        created by default so two services never cross-count).
      compilation_cache: build the planner's CUDA kernels at startup into
        the persistent kernel build directory
        (:func:`repro_torch.kernels.backend.enable_compilation_cache`), so
        the first ticket pays no ``nvcc`` and a restarted service reuses
        the built libraries; the directory lands in
        ``self.compile_cache_dir``. Unlike the reference, which swallows
        any error of its jax cache hook, a build failure raises here: a
        kernel that does not build must fail the service's start, not
        surface later as a degraded ``asap`` plan.
      injector: optional :class:`~repro_torch.runtime.fault
        .ServiceFaultInjector` — the chaos seam.
    """

    def __init__(self, planner: Planner, *, workers: int = 1,
                 max_queue: int = 64, max_batch: int = 8,
                 default_budget: float | None = None, aging: float = 30.0,
                 heartbeat_timeout: float = 5.0,
                 retries: int = 2, backoff: float = 0.02,
                 ilp_time_limit: float = 30.0,
                 lp_retry_budget_bytes: int = 8 * 2**20,
                 fallback_variants: tuple[str, ...] = ("asap", "pressWR-LS"),
                 journal_dir: str | None = None,
                 journal_replay_cap: int | None = None,
                 compact_journal: bool = True,
                 compilation_cache: bool = True,
                 registry: obs.MetricsRegistry | None = None,
                 injector=None):
        self._base = planner
        self.workers = max(int(workers), 1)
        self.max_queue = int(max_queue)
        self.max_batch = max(int(max_batch), 1)
        self.default_budget = default_budget
        self.aging = float(aging)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.retries = max(int(retries), 0)
        self.backoff = float(backoff)
        self.ilp_time_limit = float(ilp_time_limit)
        self.lp_retry_budget_bytes = int(lp_retry_budget_bytes)
        self.fallback_variants = tuple(fallback_variants)
        self.injector = injector
        self.compile_cache_dir = enable_compilation_cache(
            planner.device) if compilation_cache else None
        self._planners: dict[tuple[str, bool], Planner] = {}
        self._planners_lock = threading.Lock()
        # EMA of observed per-candidate mapping-search seconds, feeding
        # the budget-aware fallback (how many candidates the remaining
        # deadline budget affords); None until the first search delivers
        self._mapping_cand_ema: float | None = None
        self._cond = threading.Condition()
        # (vdeadline, seq, ticket) min-heap; resolved tickets are removed
        # lazily on claim. seq breaks vdeadline ties FIFO.
        self._queue: list[tuple[float, int, Ticket]] = []
        self._journal = TicketJournal(journal_dir) if journal_dir else None
        self.journal_replay_cap = None if journal_replay_cap is None \
            else max(int(journal_replay_cap), 0)
        self._compact_journal = bool(compact_journal)
        # advanced past every live journal entry in _replay_journal
        self._seq = itertools.count(0)
        self._paused = False
        self._closed = False
        self._killed = False
        # per-service metrics registry: stats() is a read of these, and
        # metrics_text() renders them (merged with the process-global
        # core-layer registry) as Prometheus text exposition
        self.registry = registry if registry is not None \
            else obs.MetricsRegistry()
        self._m_events = self.registry.counter(
            "plan_service_events_total",
            "service lifecycle events (admission, degradation, "
            "supervision, cancellation)", labels=("event",))
        self._m_stages = self.registry.counter(
            "plan_service_stage_served_total",
            "deliveries per fallback-chain stage", labels=("stage",))
        self._m_inflight = self.registry.gauge(
            "plan_service_inflight_solves",
            "chain-stage solves currently on the solve pool")
        self._m_depth = self.registry.gauge(
            "plan_service_queue_depth", "live tickets waiting")
        self._m_depth_max = self.registry.gauge(
            "plan_service_max_queue_depth",
            "admission queue high-watermark")
        self._m_latency = self.registry.histogram(
            "plan_service_plan_latency_seconds",
            "admission-to-delivery latency", reservoir=1024)
        # abandoned (cancelled, still unwinding) solves keep their pool
        # worker until the next token poll; spares keep chains walking
        self._solve_pool = _fut.ThreadPoolExecutor(
            max_workers=max(8, 2 * self.workers),
            thread_name_prefix="plan-service-solve")
        self.replayed: list[Ticket] = []
        self._replay_journal()
        self._slots = [_WorkerSlot(i) for i in range(self.workers)]
        for slot in self._slots:
            slot.thread = threading.Thread(
                target=self._worker_main, args=(slot,), daemon=True,
                name=f"plan-service-worker-{slot.index}")
            slot.thread.start()
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True,
            name="plan-service-supervisor")
        self._supervisor.start()

    # --- admission --------------------------------------------------------

    def submit(self, request: PlanRequest, budget: float | None = None
               ) -> Ticket:
        """Admit one request; returns a :class:`Ticket` immediately.

        Raises :class:`InvalidRequest` (malformed request — structured,
        synchronous, nothing shared was touched), :class:`Overloaded`
        (queue full), or :class:`ServiceClosed`. With a journal, the
        ticket is persisted before it becomes claimable (write-ahead).
        """
        if self._closed:
            raise ServiceClosed("plan service is closed")
        root = obs.start_span("request")
        adm = obs.start_span("admission", parent=root)
        try:
            instances, grid, names = request.resolve()
            validate_resolved(instances, grid)
        except (ValueError, TypeError) as e:
            self._bump(rejected_invalid=1)
            adm.end(outcome="rejected_invalid")
            root.end(outcome="rejected_invalid")
            raise InvalidRequest(f"rejected at admission: {e}",
                                 reason=str(e)) from e
        solver = request.solver if request.solver else "heuristic"
        engine = resolve_engine(
            self._base.engine, fanout=len(instances) * len(grid[0])) \
            if solver == "heuristic" else "numpy"
        if budget is None:
            budget = self.default_budget
        ticket = Ticket(request, instances, grid, names, engine, budget,
                        aging=self.aging)
        ticket._service = self
        ticket.span = root.set(solver=ticket.solver, engine=engine,
                               cells=ticket.cells, budget=budget)
        with self._cond:
            if self._closed:
                adm.end(outcome="closed")
                root.end(outcome="closed")
                raise ServiceClosed("plan service is closed")
            depth = sum(1 for _, _, t in self._queue if not t.done())
            if depth >= self.max_queue:
                self._bump(rejected_overloaded=1)
                adm.end(outcome="rejected_overloaded")
                root.end(outcome="rejected_overloaded")
                raise Overloaded(
                    f"admission queue full ({depth} waiting)",
                    queue_depth=depth, max_queue=self.max_queue)
            seq = next(self._seq)
            if self._journal is not None:
                ticket.journal_seq = seq
                self._journal.record(seq, encode_ticket(
                    instances, grid, names, ticket.solver, ticket.robust,
                    ticket.options, budget, mapping=ticket.mapping,
                    mapping_options=ticket.mapping_options))
            heapq.heappush(self._queue, (ticket.vdeadline, seq, ticket))
            self._bump(submitted=1)
            self._m_depth.set(depth + 1)
            self._m_depth_max.set_max(depth + 1)
            adm.end(seq=seq, queue_depth=depth + 1)
            ticket._wait_span = obs.start_span("queue_wait", parent=root)
            self._cond.notify_all()
        return ticket

    def plan(self, request: PlanRequest, budget: float | None = None
             ) -> PlanResult:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(request, budget=budget).result()

    def _replay_journal(self) -> None:
        """Re-admit every admitted-but-unfinished ticket a dead service
        left in the journal (at-least-once: an entry whose answer was
        delivered but not yet erased replays too — it simply re-resolves
        and clears).

        The journal is compacted first (sequence numbers renumber to
        ``0..k-1``; replayed tickets carry the compacted numbers), and
        ``journal_replay_cap`` bounds how many entries are loaded —
        deferred entries stay on disk, counted in ``replay_deferred``,
        and are picked up (oldest first) by a later restart. Either way
        ``self._seq`` resumes past every live entry, so new admissions
        never collide with deferred ones."""
        if self._journal is None:
            return
        if self._compact_journal:
            self._journal.compact()
        pending = self._journal.pending(limit=self.journal_replay_cap)
        deferred = len(self._journal) - len(pending)
        if deferred > 0:
            self._bump(replay_deferred=deferred)
        for seq, state in pending:
            try:
                decoded = decode_ticket(state)
                (instances, grid, names, solver, robust, options,
                 budget) = decoded
                validate_resolved(instances, grid)
            except Exception:
                self._journal.resolve(seq)
                self._bump(replay_corrupt=1)
                continue
            req = PlanRequest(
                instances=instances, profiles=grid,
                variants=names if solver == "heuristic" else None,
                robust=robust, solver=solver, solver_options=options,
                mapping=decoded.mapping,
                mapping_options=decoded.mapping_options)
            engine = resolve_engine(
                self._base.engine,
                fanout=len(instances) * len(grid[0])) \
                if solver == "heuristic" else "numpy"
            ticket = Ticket(req, instances, grid, names, engine, budget,
                            aging=self.aging)
            ticket._service = self
            ticket.journal_seq = seq
            ticket.span = obs.start_span(
                "request", solver=solver, engine=engine, replayed=True,
                seq=seq)
            ticket._wait_span = obs.start_span("queue_wait",
                                               parent=ticket.span)
            heapq.heappush(self._queue, (ticket.vdeadline, seq, ticket))
            self.replayed.append(ticket)
            self._bump(submitted=1, replayed=1)
        self._seq = itertools.count(self._journal.next_seq())

    # --- worker pool ------------------------------------------------------

    def _has_work(self) -> bool:
        """Prune resolved heap heads; True if a live ticket waits.
        Caller holds ``_cond``."""
        while self._queue and self._queue[0][2].done():
            heapq.heappop(self._queue)
        return bool(self._queue)

    def _claim_batch(self) -> list[Ticket] | None:
        """Pop the earliest-deadline live ticket plus up to
        ``max_batch - 1`` coalescable queue-mates. Caller holds
        ``_cond``. Mates are taken in deadline order; claiming a mate
        *past* a non-coalescable earlier ticket is counted as a
        priority inversion (the price of batching)."""
        if not self._has_work():
            return None
        lead = heapq.heappop(self._queue)[2]
        batch = [lead]
        if self.max_batch > 1 and self._queue:
            key = lead._coalesce_key()
            keep, inversions, passed_other = [], 0, False
            for entry in sorted(self._queue):
                t = entry[2]
                if t.done():
                    continue
                if len(batch) < self.max_batch and \
                        t._coalesce_key() == key:
                    if passed_other:
                        inversions += 1
                    batch.append(t)
                else:
                    keep.append(entry)
                    passed_other = True
            self._queue[:] = keep
            heapq.heapify(self._queue)
            if inversions:
                self._bump(priority_inversions=inversions)
        return batch

    def _worker_main(self, slot: _WorkerSlot) -> None:
        try:
            self._worker_loop(slot)
        except SimulatedFailure:
            # injected worker death: die with slot.current still set so
            # the supervisor requeues the claimed tickets
            pass

    def _worker_loop(self, slot: _WorkerSlot) -> None:
        gen = slot.generation
        while True:
            with self._cond:
                while not self._closed and slot.generation == gen and \
                        (self._paused or not self._has_work()):
                    slot.heartbeat = time.monotonic()
                    self._cond.wait(timeout=0.05)
                if self._closed or slot.generation != gen:
                    return
                batch = self._claim_batch()
                if batch is None:
                    continue
                slot.current = batch
                slot.heartbeat = time.monotonic()
            spec = self.injector.on_worker() \
                if self.injector is not None else None
            if spec is not None:
                if spec.kind == "kill":
                    self.kill()
                    return
                if spec.kind == "worker-death":
                    raise SimulatedFailure("injected worker death")
                # "wedge": stall WITHOUT heartbeating until the
                # supervisor deposes this generation (or the scripted
                # stall ends first under a long heartbeat_timeout)
                stall = time.monotonic() + spec.seconds
                while time.monotonic() < stall:
                    if slot.generation != gen:
                        return          # deposed; tickets were requeued
                    time.sleep(0.005)
            try:
                self._serve_batch(batch, slot, gen)
            finally:
                with self._cond:
                    if slot.generation == gen:
                        slot.current = None
                        slot.token = None

    def _supervise(self) -> None:
        """Detect dead/wedged workers and replace them (see
        :class:`_WorkerSlot`). Healthy workers heartbeat from their
        queue wait and from the watchdog poll during solves, so only a
        genuinely stalled worker loop trips the timeout."""
        interval = max(min(self.heartbeat_timeout / 4.0, 0.05), 0.005)
        while not self._closed:
            for slot in self._slots:
                if self._closed:
                    return
                if slot.thread is not None and not slot.thread.is_alive():
                    self._restart(slot, "worker died")
                elif slot.current is not None and \
                        time.monotonic() - slot.heartbeat \
                        > self.heartbeat_timeout:
                    self._restart(slot, "worker wedged")
            time.sleep(interval)

    def _restart(self, slot: _WorkerSlot, reason: str) -> None:
        requeued = 0
        with self._cond:
            if self._closed:
                return
            slot.generation += 1
            token, current = slot.token, slot.current or []
            slot.current = None
            slot.token = None
            if token is not None:
                token.cancel(reason)
            for t in current:
                if not t.done():
                    heapq.heappush(self._queue,
                                   (t.vdeadline, next(self._seq), t))
                    requeued += 1
            slot.heartbeat = time.monotonic()
            slot.thread = threading.Thread(
                target=self._worker_main, args=(slot,), daemon=True,
                name=f"plan-service-worker-{slot.index}")
            slot.thread.start()
            self._cond.notify_all()
        self._bump(worker_restarts=1, requeued=requeued)

    # --- batch assembly: corruption quarantine ----------------------------

    def _serve_batch(self, tickets: list[Ticket], slot: _WorkerSlot,
                     gen: int) -> None:
        healthy = []
        for t in tickets:
            if t.done():                       # cancelled while queued
                continue
            t._wait_span.end()                 # claimed: the wait is over
            grid = t.grid
            if self.injector is not None and self.injector.corrupts_request():
                # the chaos seam poisons this ticket's profiles in flight
                grid = [[corrupt_profile(p) for p in ps] for ps in grid]
                t.grid = grid
            try:
                validate_resolved(t.instances, grid)
            except ValueError as e:
                self._bump(quarantined=1)
                self._reject(t, InvalidRequest(
                    f"quarantined at batch assembly: {e}", reason=str(e)))
                continue
            healthy.append(t)
        if healthy:
            self._bump(batches=1, coalesced_requests=len(healthy))
            self._run_chain(healthy, slot=slot, gen=gen)

    # --- the degradation ladder -------------------------------------------

    def _chain_for(self, solver: str) -> tuple[str, ...]:
        return FALLBACK_CHAINS.get(solver, (solver, "asap"))

    def _remaining(self, tickets) -> float | None:
        rs = [r for r in (t.remaining() for t in tickets) if r is not None]
        return min(rs) if rs else None

    def _watch(self, fut: _fut.Future, slot: _WorkerSlot | None, gen: int,
               token: CancelToken, budget: float | None):
        """Poll one stage solve to completion, heartbeating the worker
        slot. Raises TimeoutError at the budget, or ``Cancelled`` when
        this worker generation was deposed mid-solve (the supervisor
        already requeued the tickets; the solve is cancelled and
        abandoned)."""
        deadline = None if budget is None else time.monotonic() + budget
        while True:
            if slot is not None:
                slot.heartbeat = time.monotonic()
                if slot.generation != gen:
                    token.cancel("worker deposed")
                    fut.add_done_callback(_swallow)
                    raise Cancelled("worker deposed")
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise _fut.TimeoutError()
            step = 0.05 if left is None else min(0.05, max(left, 0.001))
            try:
                return fut.result(timeout=step)
            except _fut.TimeoutError:
                continue

    def _run_chain(self, tickets: list[Ticket],
                   attempts: list[str] | None = None,
                   slot: _WorkerSlot | None = None, gen: int = 0) -> None:
        attempts = attempts if attempts is not None else []
        chain = self._chain_for(tickets[0].solver)
        # rung spans parent to the LEAD ticket's trace (one connected
        # tree per batch); batch-mates' own roots link up at resolution
        lead = tickets[0]
        for si, stage in enumerate(chain):
            terminal = si == len(chain) - 1
            remaining = self._remaining(tickets)
            if remaining is not None and remaining <= 0 and not terminal:
                # budget exhausted: jump straight to the terminal rung,
                # which still returns a feasible schedule
                attempts.append(f"{stage}:skipped")
                obs.start_span(f"rung:{stage}", parent=lead.span,
                               stage=stage, outcome="skipped").end()
                continue
            blocked = False
            attempt = 0
            while attempt <= self.retries:
                if all(t.done() for t in tickets):
                    return                     # cancelled under us
                remaining = self._remaining(tickets)
                budget = None if (remaining is None or terminal) \
                    else max(remaining, 0.05)
                token = CancelToken.with_budget(budget)
                for t in tickets:
                    t._batch = tickets
                    t._stage_token = token
                if slot is not None:
                    slot.token = token
                rung = obs.start_span(
                    f"rung:{stage}", parent=lead.span, stage=stage,
                    attempt=attempt, tickets=len(tickets),
                    blocked_lp=blocked,
                    budget=None if budget is None else round(budget, 3))
                fut = self._solve_pool.submit(
                    self._solve_once, stage, tickets, remaining, blocked,
                    token, rung)
                try:
                    res = self._watch(fut, slot, gen, token, budget)
                except _fut.TimeoutError:
                    # cancel the abandoned solve: it unwinds at its next
                    # token poll and frees its pool worker
                    token.cancel("deadline budget exceeded")
                    fut.add_done_callback(_swallow)
                    attempts.append(f"{stage}:timeout")
                    self._bump(timeouts=1)
                    rung.end(outcome="timeout")
                    break                              # next stage
                except Cancelled:
                    if token.reason == "deadline expired":
                        # the solve timed itself out via the token's own
                        # deadline (same budget the watchdog enforces)
                        attempts.append(f"{stage}:timeout")
                        self._bump(timeouts=1)
                        rung.end(outcome="timeout")
                        break                          # next stage
                    # client cancelled every ticket, or this worker was
                    # deposed (tickets requeued) — either way the chain
                    # is no longer ours to walk
                    attempts.append(f"{stage}:cancelled")
                    self._bump(cancelled_solves=1)
                    rung.end(outcome="cancelled")
                    return
                except SimulatedFailure:
                    attempts.append(f"{stage}:crash")
                    self._bump(retries=1)
                    rung.end(outcome="crash")
                    attempt += 1
                    if attempt > self.retries:
                        break
                    time.sleep(self.backoff * (2 ** (attempt - 1)))
                    continue
                except (MemoryError, torch.OutOfMemoryError) as e:
                    attempts.append(f"{stage}:oom")
                    rung.end(outcome="oom")
                    if isinstance(e, torch.OutOfMemoryError):
                        # hand the failed solve's cached blocks back before
                        # the blocked-LP retry allocates on the same card
                        torch.cuda.empty_cache()
                    if blocked:
                        break                          # blocked retry used
                    blocked = True
                    self._bump(oom_retries=1)
                    attempts.append(f"{stage}:oom-retry-blocked-lp")
                    continue
                except Exception as e:
                    attempts.append(f"{stage}:error")
                    rung.end(outcome="error", error=type(e).__name__)
                    if len(tickets) > 1:
                        # quarantine bisect: a poisoned batch-mate must
                        # not take the others down — every ticket re-runs
                        # its chain alone, so exactly the poison fails
                        self._bump(splits=1)
                        for t in tickets:
                            self._run_chain(
                                [t], attempts=["quarantine:split"],
                                slot=slot, gen=gen)
                        return
                    if terminal:
                        self._fail(tickets, attempts, e)
                        return
                    break                              # next stage
                else:
                    attempts.append(f"{stage}:ok")
                    rung.end(outcome="ok")
                    self._deliver(tickets, res, stage, attempts)
                    return
        self._fail(tickets, attempts, None)

    def _planner_for(self, engine: str, blocked: bool) -> Planner:
        key = (engine, blocked)
        with self._planners_lock:
            p = self._planners.get(key)
            if p is None:
                p = self._base.clone(
                    engine=engine,
                    lp_budget_bytes=self.lp_retry_budget_bytes if blocked
                    else None)
                self._planners[key] = p
            return p

    def _solve_once(self, stage: str, tickets: list[Ticket],
                    remaining: float | None, blocked: bool,
                    cancel: CancelToken | None = None,
                    rung: "obs.Span | None" = None) -> PlanResult:
        """One chain-stage solve of the whole batch (runs on the solve
        pool; the watchdog can abandon it and ``cancel`` stops it).
        ``rung`` re-anchors this pool thread to the chain walker's rung
        span, so the planner/solver spans nest under the right trace."""
        self._m_inflight.inc()
        try:
            with obs.attach(rung), obs.span(
                    "solve", stage=stage, tickets=len(tickets),
                    cells=sum(t.cells for t in tickets)):
                if self.injector is not None:
                    self.injector.on_solve(stage, cancel=cancel)
                requested = tickets[0].solver
                # mapping modes ride every chain stage (the instances
                # are raw Workflows); non-requested fallback stages
                # degrade "search" budget-aware — shrink the search to
                # what the remaining deadline budget affords, dropping
                # to the cheap deterministic "heft" only when even a
                # minimal search does not fit (see _degrade_mapping)
                mapping = tickets[0].mapping
                mapping_options = tickets[0].mapping_options
                if stage == requested:
                    variants = tickets[0].names \
                        if requested == "heuristic" else None
                    options = dict(tickets[0].options or {})
                else:
                    variants = self.fallback_variants \
                        if stage == "heuristic" else None
                    options = {}
                    if mapping != "fixed":
                        mapping, mapping_options = self._degrade_mapping(
                            stage, mapping, mapping_options,
                            remaining, n_workflows=sum(
                                len(t.instances) for t in tickets))
                if stage in ("ilp", "exact"):
                    limit = options.get("time_limit", self.ilp_time_limit)
                    if remaining is not None:
                        limit = min(float(limit), max(remaining, 0.1))
                    options["time_limit"] = limit
                if stage == "heuristic":
                    engine = tickets[0].engine \
                        if requested == "heuristic" else \
                        resolve_engine(self._base.engine,
                                       fanout=sum(t.cells
                                                  for t in tickets))
                else:
                    engine = "numpy"
                planner = self._planner_for(
                    engine, blocked and stage == "heuristic")
                req = PlanRequest(
                    instances=[i for t in tickets for i in t.instances],
                    profiles=[ps for t in tickets for ps in t.grid],
                    variants=variants, robust=tickets[0].robust,
                    solver=stage, solver_options=options or None,
                    mapping=mapping, mapping_options=mapping_options)
                return planner.plan(req, cancel=cancel)
        finally:
            self._m_inflight.dec()
            self._bump(cancel_checks=cancel.checks
                       if cancel is not None else 0)

    # --- budget-aware mapping degradation ---------------------------------

    # per-candidate seconds assumed before any search has delivered, the
    # budget fraction the mapping phase may spend (the schedule solve
    # needs the rest), and the EMA smoothing of observed costs
    _MAPPING_CAND_DEFAULT = 0.25
    _MAPPING_BUDGET_FRACTION = 0.5
    _MAPPING_EMA_ALPHA = 0.3
    # candidate cap for budget-less fallback rungs: the rung was reached
    # on a solver error, not deadline pressure, so keep a small search
    _MAPPING_FALLBACK_CAP = 8

    def _degrade_mapping(self, stage: str, mapping: str, mapping_options,
                         remaining: float | None, n_workflows: int
                         ) -> tuple[str, object]:
        """Mapping mode for a non-requested fallback rung.

        ``mapping="search"`` is shrunk to the candidate count the
        remaining deadline budget affords (per-candidate cost = EMA of
        delivered searches, split across the batch's workflows) via
        :meth:`MappingOptions.shrunk_to`, and only drops to plain HEFT
        when even a 2-candidate search does not fit — or on the terminal
        ``asap`` rung, which must stay worst-case cheap. The delivered
        result surfaces the choice: ``attempts`` carries a
        ``mapping:<mode>`` marker and ``mapping_info`` shows the shrunk
        search's real candidate count.
        """
        if mapping != "search" or stage == "asap":
            return "heft", None
        from repro_torch.mapping.options import MappingOptions

        opts = MappingOptions.from_dict(mapping_options)
        if remaining is None:
            afford = self._MAPPING_FALLBACK_CAP
        else:
            per_cand = self._mapping_cand_ema \
                if self._mapping_cand_ema is not None \
                else self._MAPPING_CAND_DEFAULT
            afford = int(max(remaining, 0.0) * self._MAPPING_BUDGET_FRACTION
                         / (per_cand * max(n_workflows, 1)))
        shrunk = opts.shrunk_to(afford)
        if shrunk is None:
            self._bump(mapping_heft_downgrades=1)
            return "heft", None
        if shrunk is not opts:
            self._bump(mapping_search_shrinks=1)
        return "search", shrunk.to_dict()

    def _note_mapping_cost(self, res: PlanResult) -> None:
        """Fold a delivered search's per-candidate seconds into the EMA
        the budget-aware fallback plans with."""
        for info in (res.mapping_info or ()):
            if getattr(info, "mode", None) == "search" and info.candidates:
                per = info.seconds / info.candidates
                a = self._MAPPING_EMA_ALPHA
                self._mapping_cand_ema = per \
                    if self._mapping_cand_ema is None \
                    else (1 - a) * self._mapping_cand_ema + a * per

    # --- delivery ---------------------------------------------------------

    def _deliver(self, tickets: list[Ticket], res: PlanResult, stage: str,
                 attempts: list[str]) -> None:
        requested = tickets[0].solver
        if getattr(res, "mapping_mode", "fixed") != "fixed":
            # surface the rung's mapping decision (search kept/shrunk vs
            # downgraded to heft) next to the stage markers
            attempts = attempts + [f"mapping:{res.mapping_mode}"]
            self._note_mapping_cost(res)
        now = time.monotonic()
        i0 = 0
        for t in tickets:
            i1 = i0 + len(t.instances)
            lower = None if res.lower_bound is None \
                else res.lower_bound[i0:i1]
            gaps = None if res.mip_gap is None else res.mip_gap[i0:i1]
            open_gap = gaps is not None and bool(
                np.any(np.nan_to_num(gaps, nan=0.0) > 1e-9))
            sub = PlanResult(
                variants=res.variants, results=res.results[i0:i1],
                costs=res.costs[i0:i1], engine=res.engine,
                seconds=res.seconds, robust_requested=res.robust_requested,
                solver=res.solver, lower_bound=lower, mip_gap=gaps,
                degraded=(stage != requested) or open_gap,
                fallback_stage=stage, attempts=tuple(attempts),
                mapping_mode=res.mapping_mode,
                mappings=None if res.mappings is None
                else res.mappings[i0:i1],
                mapping_info=None if res.mapping_info is None
                else res.mapping_info[i0:i1])
            if _try_resolve(t._fut, sub):
                self._bump(completed=1, degraded=1 if sub.degraded else 0)
                self._m_stages.inc(stage=stage)
                self._m_latency.observe(now - t.admitted)
                self._journal_resolve(t)
                t._wait_span.end()
                obs.start_span("resolution", parent=t.span, stage=stage,
                               degraded=sub.degraded,
                               coalesced=len(tickets)).end()
                t.span.end(outcome="completed", stage=stage,
                           degraded=sub.degraded)
            i0 = i1

    def _journal_resolve(self, ticket: Ticket) -> None:
        if self._journal is not None and ticket.journal_seq is not None:
            try:
                self._journal.resolve(ticket.journal_seq)
            except OSError:
                pass

    def _note_cancel(self, ticket: Ticket) -> None:
        """Bookkeeping after a won :meth:`Ticket.cancel`: drop the
        journal entry and, when every batch-mate of an in-flight solve
        is also done, cancel the solve itself through the stage token."""
        self._bump(cancelled=1)
        self._journal_resolve(ticket)
        ticket._wait_span.end()
        ticket.span.end(outcome="cancelled")
        batch, token = ticket._batch, ticket._stage_token
        if batch is not None and token is not None and \
                all(t.done() for t in batch):
            token.cancel("all batch tickets cancelled")
        with self._cond:
            self._cond.notify_all()

    def _reject(self, ticket: Ticket, err: ServiceError) -> bool:
        won = _try_reject(ticket._fut, err)
        if won:
            self._journal_resolve(ticket)
            ticket._wait_span.end()
            ticket.span.end(outcome=err.code)
        return won

    def _fail(self, tickets: list[Ticket], attempts: list[str],
              last: Exception | None) -> None:
        for t in tickets:
            if self._reject(t, PlanFailure(
                    "every fallback stage failed"
                    + (f" (last: {last})" if last is not None else ""),
                    attempts=tuple(attempts),
                    last_error=repr(last) if last is not None else None)):
                self._bump(failed=1)

    # --- telemetry / lifecycle --------------------------------------------

    def _bump(self, **deltas) -> None:
        """Shim from the pre-registry ``Counter`` spelling onto the
        per-service metrics registry (one labeled counter per event)."""
        for k, v in deltas.items():
            if v:
                self._m_events.inc(v, event=k)

    def stats(self) -> dict:
        """Service telemetry snapshot: admission/degradation counters,
        worker supervision counters, cancellation counters, coalescing
        ratio, and plan-latency percentiles.

        This is a read of ``self.registry`` — the wire shape predates
        the registry and is preserved exactly; :meth:`metrics_text`
        exposes the same numbers as Prometheus text exposition."""
        with self._cond:
            depth = sum(1 for _, _, t in self._queue if not t.done())
        self._m_depth.set(depth)
        c = {k: int(self._m_events.value(event=k)) for k in _STAT_EVENTS}
        lat = np.asarray(self._m_latency.samples(), dtype=np.float64)
        stages = {key[0]: int(v)
                  for key, v in self._m_stages.values().items()}
        batches = c.get("batches", 0)
        served = c.get("coalesced_requests", 0)
        return {
            **c,
            "inflight_solves": int(self._m_inflight.value()),
            "max_queue_depth": int(self._m_depth_max.value()),
            "workers": self.workers,
            "queue_depth": depth,
            "coalesce_ratio": served / batches if batches else None,
            "stages": stages,
            "latency": {
                "n": int(lat.size),
                "p50_ms": float(np.percentile(lat, 50) * 1e3)
                if lat.size else None,
                "p99_ms": float(np.percentile(lat, 99) * 1e3)
                if lat.size else None,
            },
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of this service's registry merged
        with the process-global core-layer registry — serve it verbatim
        as a ``/metrics`` body."""
        return obs.render_prometheus(self.registry, obs.registry())

    def pause(self) -> None:
        """Hold the workers (drills/tests: lets callers fill the queue
        deterministically)."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def kill(self) -> None:
        """Die abruptly, as a crashed process would: workers are deposed
        mid-flight, unresolved ticket futures never resolve, and the
        journal keeps every admitted-but-unfinished entry — a new
        service on the same ``journal_dir`` replays them. The chaos
        seam's ``"kill"`` fault routes here; safe to call from a worker
        thread (no joins)."""
        with self._cond:
            if self._closed:
                return
            self._killed = True
            self._closed = True
            for slot in self._slots:
                slot.generation += 1
                if slot.token is not None:
                    slot.token.cancel("service killed")
            self._cond.notify_all()
        self._solve_pool.shutdown(wait=False, cancel_futures=True)

    def close(self) -> None:
        """Stop gracefully: in-flight batches finish, then pending
        tickets fail with :class:`ServiceClosed` — a resolution, so
        their journal entries are erased (a clean close leaves an empty
        journal; only :meth:`kill` leaves replayable entries)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending = [t for _, _, t in self._queue if not t.done()]
            self._queue.clear()
            self._cond.notify_all()
        for slot in self._slots:
            if slot.thread is not None:
                slot.thread.join(timeout=30.0)
        self._supervisor.join(timeout=5.0)
        for t in pending:
            self._reject(t, ServiceClosed("plan service closed before "
                                          "this ticket was served"))
        self._solve_pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "PlanService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
