"""Fault tolerance: failure injection + checkpoint/restart driver.

Two injection surfaces share this module:

* :class:`FailureInjector` — the original per-step seam the training
  restart driver (:func:`run_with_restarts`) drills against;
* :class:`ServiceFaultInjector` — the planning-service chaos seam
  (:class:`repro_torch.serve.service.PlanService` accepts one as
  ``injector=``): a deterministic script of :class:`FaultSpec`\\ s fired
  at solver-chain stages (crash, hang, device OOM, generic poison
  error) plus per-request profile corruption, so the chaos suite can
  drive every degradation path end-to-end with exact repeatability.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


class SimulatedFailure(RuntimeError):
    """A transient failure (retry-with-backoff is the right response)."""


class SimulatedOOM(MemoryError):
    """An injected device out-of-memory (blocked-LP retry is the right
    response — real dense ``longest_path_matrix`` overruns raise plain
    :class:`MemoryError`, which the service treats identically)."""


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault: fire ``kind`` up to ``times`` times whenever a
    matching solver-chain ``stage`` solve is attempted.

    kinds:
      * ``"crash"``   — raise :class:`SimulatedFailure` (transient;
        exercises the retry/backoff path);
      * ``"hang"``    — sleep ``seconds`` inside the solve (exercises the
        deadline-budget watchdog);
      * ``"oom"``     — raise :class:`SimulatedOOM` (exercises the
        blocked-LP retry);
      * ``"error"``   — raise a generic :class:`ValueError` (a
        non-transient poison; exercises the quarantine bisect);
      * ``"corrupt"`` — consumed per *request* at batch assembly, not per
        solve: the service replaces that request's profiles with
        structurally corrupt ones (:func:`corrupt_profile`), exercising
        admission-side quarantine.
      * ``"worker-death"`` — consumed per drain-worker batch claim: the
        worker thread raises out of its drain loop and dies (exercises
        the supervisor's dead-worker restart + ticket requeue);
      * ``"wedge"`` — consumed per drain-worker batch claim: the worker
        stalls ``seconds`` without heartbeating (exercises the
        supervisor's wedged-worker deposition);
      * ``"kill"`` — consumed per batch claim: the whole service dies
        mid-burst (:meth:`repro_torch.serve.service.PlanService.kill`),
        leaving admitted tickets in the journal (exercises restart
        replay).

    ``stage=None`` matches every chain stage. Specs are consumed in
    order, deterministically — no clock or RNG involvement unless
    ``ServiceFaultInjector(prob=...)`` is used.
    """

    kind: str
    stage: str | None = None
    times: int = 1
    seconds: float = 0.25

    KINDS = ("crash", "hang", "oom", "error", "corrupt",
             "worker-death", "wedge", "kill")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


def corrupt_profile(profile):
    """A structurally corrupt twin of ``profile``: its budget array loses
    one interval, so ``len(budget) != len(bounds) - 1`` — the invariant
    :func:`repro_torch.api.request.validate_resolved` checks and every cost
    oracle relies on."""
    from repro_torch.core.carbon import PowerProfile

    return PowerProfile(bounds=profile.bounds.copy(),
                        budget=profile.budget[:-1].copy(),
                        scenario=profile.scenario + "-corrupt")


class ServiceFaultInjector:
    """Deterministic chaos seam for :class:`~repro_torch.serve.service
    .PlanService`.

    ``faults`` is a scripted list of :class:`FaultSpec`; ``prob``/``seed``
    add the legacy seeded-random mode on top (every solve attempt crashes
    with probability ``prob``, reproducible per seed). ``fired`` logs
    every injected event as ``(kind, stage)`` for test assertions.
    """

    def __init__(self, faults=(), prob: float = 0.0, seed: int = 0):
        self.faults = [dataclasses.replace(f) for f in faults]
        self.prob = float(prob)
        self.rng = np.random.default_rng(seed)
        self.fired: list[tuple[str, str | None]] = []

    def _take(self, kinds, stage: str | None) -> FaultSpec | None:
        for spec in self.faults:
            if spec.kind in kinds and spec.times > 0 and \
                    (spec.stage is None or spec.stage == stage):
                spec.times -= 1
                self.fired.append((spec.kind, stage))
                return spec
        return None

    def on_solve(self, stage: str, cancel=None) -> None:
        """Called by the service inside every chain-stage solve attempt
        (before the actual plan); may raise or stall.

        ``cancel`` is the solve's
        :class:`repro_torch.core.cancel.CancelToken`:
        an injected ``"hang"`` sleeps in small slices polling it, so a
        watchdog-cancelled hang releases its solve-pool worker within
        ~10ms instead of holding it for the scripted duration (a real
        wedged solve behaves the same way once its own chunk boundary
        polls the token).
        """
        spec = self._take(("crash", "hang", "oom", "error"), stage)
        if spec is None:
            if self.prob and self.rng.random() < self.prob:
                self.fired.append(("crash", stage))
                raise SimulatedFailure(
                    f"injected random failure at stage {stage!r}")
            return
        if spec.kind == "crash":
            raise SimulatedFailure(f"injected crash at stage {stage!r}")
        if spec.kind == "oom":
            raise SimulatedOOM(f"injected device OOM at stage {stage!r}")
        if spec.kind == "error":
            raise ValueError(f"injected poison error at stage {stage!r}")
        deadline = time.monotonic() + spec.seconds     # "hang"
        while time.monotonic() < deadline:
            if cancel is not None:
                cancel.check()
            time.sleep(0.01)

    def on_worker(self) -> FaultSpec | None:
        """Called by each drain worker once per batch claim; returns the
        consumed worker-level :class:`FaultSpec` (kind
        ``"worker-death"``, ``"wedge"`` or ``"kill"``) or None. The
        service acts on the kind — raising out of the drain loop,
        stalling without heartbeating for ``spec.seconds``, or killing
        the whole service mid-burst."""
        return self._take(("worker-death", "wedge", "kill"), None)

    def corrupts_request(self) -> bool:
        """Called by the service once per admitted request at batch
        assembly; True consumes a ``"corrupt"`` spec and tells the
        service to poison that request's profiles."""
        return self._take(("corrupt",), None) is not None


class FailureInjector:
    """Deterministic pseudo-random failures for tests/drills."""

    def __init__(self, prob_per_step: float, seed: int = 0):
        self.prob = prob_per_step
        self.rng = np.random.default_rng(seed)

    def maybe_fail(self, step: int) -> None:
        if self.rng.random() < self.prob:
            raise SimulatedFailure(f"injected failure at step {step}")


def run_with_restarts(train_fn, ckpt_manager, init_state_fn, total_steps: int,
                      max_restarts: int = 10):
    """Run ``train_fn(state, start_step, stop_step)`` with restart-on-failure.

    ``train_fn`` must checkpoint through ``ckpt_manager`` and raise on
    failure; restarts resume from the latest manifest (the data pipeline is
    deterministic per step, so the stream resumes exactly).
    Returns (final_state, steps_done, n_restarts).
    """
    restarts = 0
    while True:
        state, step = ckpt_manager.restore_latest()
        if state is None:
            state, step = init_state_fn(), -1
        start = step + 1
        try:
            state = train_fn(state, start, total_steps)
            return state, total_steps, restarts
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
