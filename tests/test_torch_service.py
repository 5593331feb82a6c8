"""Port parity, the serving tier: repro_torch's PlanService against a direct
port Planner.plan (bitwise) and against repro's PlanService on the same
script (attempts logs, stats() counters, error wire shapes); the ticket
journal's entries across packages; validate_resolved's messages; the
torch-specific OOM and kernel-build branches. At tests/test_service.py's
sizes, on the CPU (``device="cpu"``). Every wait carries a timeout and
every service is closed in a ``with`` block or a ``finally``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch.api as t_api
import repro_torch.serve as t_serve
import repro_torch.serve.journal as t_journal
from repro_torch import interop
from repro_torch.api.request import validate_resolved as t_validate
from repro_torch.core import validate_schedule
from repro_torch.mapping import MappingOptions
from repro_torch.runtime import fault as t_fault

try:
    import repro.api as r_api
    import repro.serve as r_serve
    import repro.serve.journal as r_journal
    from repro.api.request import validate_resolved as r_validate
    from repro.cluster import make_cluster
    from repro.core import (build_instance, deadline_from_asap,
                            generate_profile, heft_mapping)
    from repro.runtime import fault as r_fault
    from repro.workflows import Workflow as RWorkflow
    from repro.workflows import make_workflow
except ImportError:
    # the GPU host has no JAX; there `-m cuda` selects only the kernel
    # build test below, which needs neither jax nor repro
    r_api = None

# stats() keys whose values depend on timing, not on the script
_TIMING_KEYS = ("latency", "inflight_solves", "max_queue_depth",
                "queue_depth")


class Side:
    """One package's service surface, so a script runs unchanged on the
    reference (``repro``) and on the port (``repro_torch``, on the CPU).
    ``obj`` hands a reference-built object to this side."""

    def __init__(self, port: bool):
        self.port = port
        api, serve, fault = (t_api, t_serve, t_fault) if port \
            else (r_api, r_serve, r_fault)
        self.PlanRequest = api.PlanRequest
        self.FaultSpec = fault.FaultSpec
        self.Injector = fault.ServiceFaultInjector
        self.serve = serve
        self._Planner = api.Planner

    def obj(self, x):
        if not self.port:
            return x
        if isinstance(x, (list, tuple)):
            return type(x)(self.obj(y) for y in x)
        return interop.port(x)

    def planner(self, plat, engine="numpy", **kw):
        if self.port:
            kw["device"] = "cpu"
        return self._Planner(self.obj(plat), engine=engine, **kw)

    def service(self, planner, **kw):
        # the reference's default turns on jax's persistent cache under
        # HOME; its parity runs here need no cache
        if not self.port:
            kw.setdefault("compilation_cache", False)
        return self.serve.PlanService(planner, **kw)


REF = Side(False) if r_api is not None else None
PORT = Side(True)


def _setup(kind="eager", samples=3, seed=3, factor=1.5, scenario="S3"):
    plat = make_cluster(1, seed=seed)
    wf = make_workflow(kind, samples, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, factor)
    prof = generate_profile(scenario, T, plat, J=16, seed=seed)
    return plat, inst, prof


def _second(plat):
    wf2 = make_workflow("eager", 2, seed=9)
    inst2 = build_instance(wf2, heft_mapping(wf2, plat), plat)
    prof2 = generate_profile("S1", deadline_from_asap(inst2, 1.5), plat,
                             J=16, seed=7)
    return inst2, prof2


def assert_same_plan(a, b):
    """Bit-identity of two PlanResults: costs, and every cell's starts."""
    assert a.variants == b.variants
    assert np.array_equal(a.costs, b.costs)
    for ra, rb in zip(a.results, b.results):
        for ca, cb in zip(ra, rb):
            for name in ca:
                assert np.array_equal(ca[name].start, cb[name].start), name


def script_stats(stats):
    return {k: v for k, v in stats.items() if k not in _TIMING_KEYS}


# --- fault-free service == direct Planner.plan ------------------------------

@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_fault_free_service_equals_direct_plan(engine, workers):
    plat, inst, prof = _setup()
    planner = PORT.planner(plat, engine=engine)
    req = PORT.PlanRequest(instances=PORT.obj(inst),
                           profiles=PORT.obj([prof, prof]))
    direct = planner.plan(req)
    with PORT.service(planner.clone(), workers=workers) as svc:
        svc.pause()
        tickets = [svc.submit(req) for _ in range(3)]
        svc.resume()
        served = [t.result(timeout=120) for t in tickets]
        stats = svc.stats()
    for res in served:
        assert_same_plan(res, direct)
        assert not res.degraded and res.fallback_stage == "heuristic"
        assert res.attempts == ("heuristic:ok",)
        assert res.engine == engine
    assert stats["batches"] == 1 and stats["coalesced_requests"] == 3
    assert stats["failed"] == 0 and stats["degraded"] == 0


def _coalesce_script(side):
    plat, inst, prof = _setup(samples=2, seed=5)
    inst2, prof2 = _second(plat)
    inst, prof, inst2, prof2 = side.obj([inst, prof, inst2, prof2])
    planner = side.planner(plat)
    d1 = planner.plan(side.PlanRequest(instances=inst, profiles=prof))
    d2 = planner.plan(side.PlanRequest(instances=inst2, profiles=prof2))
    with side.service(planner.clone()) as svc:
        svc.pause()
        ts = [svc.submit(side.PlanRequest(instances=i, profiles=p))
              for i, p in ((inst, prof), (inst2, prof2), (inst, prof))]
        svc.resume()
        served = [t.result(timeout=120) for t in ts]
        stats = svc.stats()
    for res, d in zip(served, (d1, d2, d1)):
        assert_same_plan(res, d)
        assert not res.degraded
    return served, stats


def test_coalescing_matches_reference_service():
    ref, ref_stats = _coalesce_script(REF)
    got, stats = _coalesce_script(PORT)
    assert stats["batches"] == 1 and stats["coalesced_requests"] == 3
    assert stats["coalesce_ratio"] == 3.0 and stats["latency"]["n"] == 3
    assert script_stats(stats) == script_stats(ref_stats)
    for a, b in zip(ref, got):
        assert_same_plan(a, b)
        assert a.attempts == b.attempts


def _mixed_script(side):
    plat, inst, prof = _setup()
    inst, prof = side.obj([inst, prof])
    planner = side.planner(plat)
    reqs = [side.PlanRequest(instances=inst, profiles=prof, solver="asap"),
            side.PlanRequest(instances=inst, profiles=prof)]
    direct = [planner.plan(r) for r in reqs]
    with side.service(planner.clone()) as svc:
        svc.pause()
        ts = [svc.submit(r) for r in reqs]
        svc.resume()
        served = [t.result(timeout=120) for t in ts]
        stats = svc.stats()
    for s, d in zip(served, direct):
        assert_same_plan(s, d)
    assert served[0].solver == "asap" and not served[0].degraded
    return served, stats


def test_mixed_solver_queue_matches_reference_service():
    ref, ref_stats = _mixed_script(REF)
    got, stats = _mixed_script(PORT)
    assert stats["batches"] == 2                  # different solver keys
    assert script_stats(stats) == script_stats(ref_stats)
    for a, b in zip(ref, got):
        assert_same_plan(a, b)
        assert a.attempts == b.attempts


# --- structured rejections ---------------------------------------------------

def _rejections_script(side):
    plat, inst, prof = _setup()
    tiny = generate_profile("S1", 2, plat, J=1, seed=0)
    inst, prof, tiny = side.obj([inst, prof, tiny])
    errors = []
    with side.service(side.planner(plat), max_queue=2) as svc:
        svc.pause()
        svc.submit(side.PlanRequest(instances=inst, profiles=prof))
        svc.submit(side.PlanRequest(instances=inst, profiles=prof))
        with pytest.raises(side.serve.Overloaded) as ei:
            svc.submit(side.PlanRequest(instances=inst, profiles=prof))
        errors.append(ei.value.to_dict())
        for bad in ([], tiny):
            with pytest.raises(side.serve.InvalidRequest) as ei:
                svc.submit(side.PlanRequest(instances=inst, profiles=bad))
            errors.append(ei.value.to_dict())
        svc.resume()
        stats = svc.stats()
    return errors, stats


def test_overloaded_and_invalid_match_reference_wire_shapes():
    ref_errors, ref_stats = _rejections_script(REF)
    errors, stats = _rejections_script(PORT)
    assert errors == ref_errors
    assert errors[0]["code"] == "overloaded"
    assert errors[0]["queue_depth"] == 2 and errors[0]["max_queue"] == 2
    assert [e["code"] for e in errors[1:]] == ["invalid_request"] * 2
    assert stats["rejected_overloaded"] == 1
    assert stats["rejected_invalid"] == 2
    assert script_stats(stats) == script_stats(ref_stats)


def test_closed_service_rejects_new_and_pending():
    plat, inst, prof = _setup()
    inst, prof = PORT.obj([inst, prof])
    svc = PORT.service(PORT.planner(plat))
    try:
        svc.pause()
        t = svc.submit(PORT.PlanRequest(instances=inst, profiles=prof))
    finally:
        svc.close()
    with pytest.raises(t_serve.ServiceClosed):
        t.result(timeout=10)
    with pytest.raises(t_serve.ServiceClosed):
        svc.submit(PORT.PlanRequest(instances=inst, profiles=prof))


def test_error_wire_round_trip_matches_reference():
    def errors(serve):
        return [
            serve.ServiceError("plain", hint="x"),
            serve.Overloaded("queue full", queue_depth=3, max_queue=2),
            serve.InvalidRequest("bad profile", reason="budget length"),
            serve.PlanFailure("every stage failed",
                              attempts=("heuristic:crash", "asap:crash"),
                              last_error=None),
            serve.ServiceClosed("closed"),
            serve.TicketCancelled("ticket cancelled: bye", reason="bye"),
        ]

    for r, t in zip(errors(r_serve), errors(t_serve)):
        d = t.to_dict()
        assert d == r.to_dict()
        assert d == json.loads(json.dumps(d)), type(t).__name__
        back = t_serve.ServiceError.from_dict(d)
        assert type(back) is type(t)
        assert str(back) == str(t)
        assert back.to_dict() == d


# --- priority admission + aging ----------------------------------------------

def _completion_order(named_tickets, timeout=60.0):
    order, pending = [], dict(named_tickets)
    deadline = time.monotonic() + timeout
    while pending and time.monotonic() < deadline:
        for name, t in list(pending.items()):
            if t.done():
                order.append(name)
                del pending[name]
        time.sleep(0.005)
    assert not pending, f"tickets never resolved: {sorted(pending)}"
    return order


@pytest.mark.parametrize("aging,expect", [(30.0, ["urgent", "slow"]),
                                          (0.05, ["slow", "urgent"])])
def test_priority_and_aging(aging, expect):
    """Earliest deadline first; a budget-less ticket older than ``aging``
    outranks even a tight real deadline."""
    plat, inst, prof = _setup()
    inst, prof = PORT.obj([inst, prof])
    with PORT.service(PORT.planner(plat), max_batch=1, aging=aging) as svc:
        svc.pause()
        slow = svc.submit(PORT.PlanRequest(instances=inst, profiles=prof))
        time.sleep(0.1)
        urgent = svc.submit(PORT.PlanRequest(instances=inst, profiles=prof,
                                             solver="asap"), budget=10.0)
        svc.resume()
        order = _completion_order({"slow": slow, "urgent": urgent})
    assert order == expect


# --- cooperative cancellation ------------------------------------------------

def test_cancel_queued_ticket_never_runs():
    plat, inst, prof = _setup()
    inst, prof = PORT.obj([inst, prof])
    with PORT.service(PORT.planner(plat)) as svc:
        svc.pause()
        t = svc.submit(PORT.PlanRequest(instances=inst, profiles=prof))
        assert t.cancel("changed my mind")
        assert not t.cancel()                # second cancel lost: resolved
        svc.resume()
        with pytest.raises(t_serve.TicketCancelled) as ei:
            t.result(timeout=10)
        assert ei.value.to_dict()["reason"] == "changed my mind"
        res = svc.plan(PORT.PlanRequest(instances=inst, profiles=prof))
        stats = svc.stats()
    assert not res.degraded
    assert stats["cancelled"] == 1 and stats["completed"] == 1


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_cancel_stops_inflight_solve_within_rung_budget(engine):
    """After Ticket.cancel() the solve pool goes idle within one rung
    budget (the reference's 2 s bound), not after the 30 s hang."""
    plat, inst, prof = _setup()
    inst, prof = PORT.obj([inst, prof])
    inj = t_fault.ServiceFaultInjector(
        faults=[t_fault.FaultSpec(kind="hang", stage="heuristic", times=1,
                                  seconds=30.0)])
    profiles = [prof, prof] if engine == "torch" else prof
    with PORT.service(PORT.planner(plat, engine=engine),
                      injector=inj) as svc:
        t = svc.submit(PORT.PlanRequest(instances=inst, profiles=profiles))
        deadline = time.monotonic() + 10
        while svc.stats()["inflight_solves"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        assert svc.stats()["inflight_solves"] == 1
        t0 = time.monotonic()
        assert t.cancel()
        while svc.stats()["inflight_solves"] > 0 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        latency = time.monotonic() - t0
        # the solve worker drops inflight_solves in its own thread; the
        # dispatcher bumps cancelled_solves only at _watch's next poll of
        # the future (up to 50 ms later): wait for it before reading
        while svc.stats()["cancelled_solves"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        stats = svc.stats()
        with pytest.raises(t_serve.TicketCancelled):
            t.result(timeout=5)
    assert stats["inflight_solves"] == 0
    assert latency < 2.0, latency
    assert stats["cancel_checks"] > 0
    assert stats["cancelled"] == 1 and stats["cancelled_solves"] == 1
    assert stats["completed"] == 0 and stats["failed"] == 0


# --- fault branches and their attempts logs ----------------------------------

def _fault_script(side, faults, budget=None, **svc_kw):
    plat, inst, prof = _setup()
    inst, prof = side.obj([inst, prof])
    planner = side.planner(plat)
    direct = planner.plan(side.PlanRequest(instances=inst, profiles=prof))
    inj = side.Injector(faults=[side.FaultSpec(**f) for f in faults])
    with side.service(planner.clone(), injector=inj, **svc_kw) as svc:
        res = svc.plan(side.PlanRequest(instances=inst, profiles=prof),
                       budget=budget)
        stats = svc.stats()
    return res, direct, stats, inj.fired


FAULT_SCRIPTS = {
    "exhausted-budget": ([], 0.0, {}),
    "persistent-crash": ([dict(kind="crash", stage="heuristic", times=10)],
                         None, dict(retries=1, backoff=0.01)),
    "transient-crash": ([dict(kind="crash", stage="heuristic", times=1)],
                        None, dict(retries=2, backoff=0.01)),
    "injected-oom": ([dict(kind="oom", stage="heuristic", times=1)],
                     None, {}),
}


@pytest.mark.parametrize("name", sorted(FAULT_SCRIPTS))
def test_fault_script_walks_reference_attempts(name):
    faults, budget, kw = FAULT_SCRIPTS[name]
    ref, _, ref_stats, ref_fired = _fault_script(REF, faults, budget, **kw)
    res, direct, stats, fired = _fault_script(PORT, faults, budget, **kw)
    assert res.attempts == ref.attempts
    assert (res.degraded, res.fallback_stage) == \
        (ref.degraded, ref.fallback_stage)
    assert fired == ref_fired
    assert script_stats(stats) == script_stats(ref_stats)
    assert_same_plan(res, ref)
    if not res.degraded:
        assert_same_plan(res, direct)
    plat, inst, prof = _setup()
    for n in res.variants:
        validate_schedule(PORT.obj(inst), PORT.obj(prof),
                          res.result(variant=n).start)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_cuda_oom_takes_blocked_lp_retry(engine, monkeypatch):
    """A torch.OutOfMemoryError (a RuntimeError, not a MemoryError) raised
    once inside the solve takes the blocked-LP retry; with a retry budget
    one byte under the dense matrix the retry really streams BlockedLP,
    bitwise equal to the dense plan."""
    from repro_torch.core import lp_matrix_bytes

    plat, inst, prof = _setup()
    inst, prof = PORT.obj([inst, prof])
    planner = PORT.planner(plat, engine=engine)
    req = PORT.PlanRequest(instances=inst, profiles=[prof, prof])
    dense = planner.plan(req)
    real_plan = t_api.Planner.plan
    used = []

    def plan_once_oom(self, request=None, /, cancel=None, **kw):
        used.append(self.lp_budget_bytes)
        if len(used) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real_plan(self, request, cancel=cancel, **kw)

    monkeypatch.setattr(t_api.Planner, "plan", plan_once_oom)
    budget = lp_matrix_bytes(inst.num_tasks) - 1
    with PORT.service(planner.clone(),
                      lp_retry_budget_bytes=budget) as svc:
        res = svc.plan(req)
        stats = svc.stats()
    assert res.attempts == ("heuristic:oom",
                            "heuristic:oom-retry-blocked-lp",
                            "heuristic:ok")
    assert not res.degraded and stats["oom_retries"] == 1
    assert used == [None, budget]
    assert_same_plan(res, dense)
    if engine == "torch":
        blocked = [p for (e, b), p in svc._planners.items() if b]
        assert blocked[0].prepared(inst, prof.T).lp_is_blocked


# --- compilation cache counterpart -------------------------------------------

def test_compile_cache_dir_default_and_opt_out():
    from repro_torch.kernels import _build

    plat, _, _ = _setup()
    with PORT.service(PORT.planner(plat)) as svc:
        assert svc.compile_cache_dir == str(_build.BUILD_DIR)
    with PORT.service(PORT.planner(plat), compilation_cache=False) as svc:
        assert svc.compile_cache_dir is None


def test_kernel_build_failure_at_service_start_raises(monkeypatch):
    """On a CUDA-device planner the service builds the scheduler kernels at
    start, and a failed build raises (the reference swallows its cache
    hook's errors; the port must not hide a broken kernel)."""
    from repro_torch.kernels import _build

    plat, _, _ = _setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    planner = t_api.Planner(interop.port(plat), engine="torch",
                            device="cuda")
    built = []

    def broken(name):
        built.append(name)
        raise RuntimeError(f"nvcc failed to build {name}.cu (injected)")

    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        t_serve.PlanService(planner)
    assert built == ["gain_scan"]
    with t_serve.PlanService(planner, compilation_cache=False) as svc:
        assert svc.compile_cache_dir is None


_SECOND_START_SCRIPT = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.api import Planner
from repro_torch.cluster import make_cluster
from repro_torch.kernels import _build
from repro_torch.serve import PlanService

builds = []
_build.add_build_listener(lambda name, secs: builds.append(name))
svc = PlanService(Planner(make_cluster(1, seed=0), engine="torch"))
svc.close()
print("BUILDS=" + ",".join(builds))
"""


@pytest.mark.cuda
def test_second_process_service_start_runs_no_nvcc():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    script = _SECOND_START_SCRIPT.format(src=os.path.abspath(src))
    lines = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        lines.append([ln for ln in out.stdout.splitlines()
                      if ln.startswith("BUILDS=")][0])
    assert lines[1] == "BUILDS=", lines


# --- resolved-grid validation ------------------------------------------------

def _corrupt_grids():
    plat, inst, prof = _setup()
    idx = inst.succ_idx.copy()
    idx[0] = inst.num_tasks + 5
    pidx = inst.pred_idx.copy()
    pidx[-1] = -1
    dur = inst.dur.copy()
    dur[2] = 0
    bounds = prof.bounds.copy()
    bounds[1] = bounds[2]
    wf = lambda name, w, e, ew: RWorkflow(  # noqa: E731
        name=name, node_w=np.asarray(w, np.int64),
        edges=np.asarray(e, np.int64).reshape(-1, 2),
        edge_w=np.asarray(ew, np.int64))
    short = generate_profile("S4", 4, plat, J=2, seed=0)
    return {
        "healthy": ([inst], [[prof]]),
        "budget-length": ([inst], [[r_fault.corrupt_profile(prof)]]),
        "critical-path": ([inst], [[generate_profile("S1", 2, plat, J=1,
                                                     seed=0)]]),
        "succ-adjacency": ([dataclasses.replace(inst, succ_idx=idx)],
                           [[prof]]),
        "pred-adjacency": ([dataclasses.replace(inst, pred_idx=pidx)],
                           [[prof]]),
        "duration": ([dataclasses.replace(inst, dur=dur)], [[prof]]),
        "bounds": ([inst], [[dataclasses.replace(prof, bounds=bounds)]]),
        "second-cell": ([inst, inst], [[prof], [r_fault.corrupt_profile(
            prof)]]),
        "wf-cycle": ([wf("cycle", [5, 5], [[0, 1], [1, 0]], [1, 1])],
                     [[prof]]),
        "wf-depth": ([wf("chain", np.ones(9), [[i, i + 1] for i in range(8)],
                         np.zeros(8))], [[short]]),
        "wf-empty": ([wf("empty", [], [], [])], [[prof]]),
        "wf-endpoint": ([wf("dangling", [1, 1], [[0, 7]], [1])], [[prof]]),
        "wf-weight": ([wf("zero", [0, 1], [[0, 1]], [1])], [[prof]]),
        "wf-comm": ([wf("comm", [1, 1], [[0, 1]], [-1])], [[prof]]),
        "wf-budget": ([wf("ok", [1, 1], [[0, 1]], [1])],
                      [[r_fault.corrupt_profile(prof)]]),
    }


CORRUPT_CASES = ("healthy", "budget-length", "critical-path",
                 "succ-adjacency", "pred-adjacency", "duration", "bounds",
                 "second-cell", "wf-cycle", "wf-depth", "wf-empty",
                 "wf-endpoint", "wf-weight", "wf-comm", "wf-budget")


@pytest.mark.parametrize("case", CORRUPT_CASES)
def test_validate_resolved_matches_reference_messages(case):
    grids = _corrupt_grids()
    assert sorted(grids) == sorted(CORRUPT_CASES)
    instances, grid = grids[case]

    def outcome(validate, side):
        try:
            validate(side.obj(list(instances)),
                     [side.obj(list(ps)) for ps in grid])
        except ValueError as e:
            return str(e)
        return None

    want = outcome(r_validate, REF)
    assert outcome(t_validate, PORT) == want
    assert (want is None) == (case == "healthy")


# --- the write-ahead journal -------------------------------------------------

def _journal_cases():
    plat, inst, prof = _setup()
    wf = make_workflow("methylseq", 2, seed=4)
    return {
        "instance": dict(instances=[inst], grid=[[prof, prof]],
                         names=("asap", "pressWR-LS"), solver="heuristic",
                         robust=True, options={"x": 1}, budget=2.5),
        "workflow": dict(instances=[wf], grid=[[prof]], names=("exact",),
                         solver="exact", robust=False,
                         options={"time_limit": 9.0}, budget=None,
                         mapping="search", mapping_options={"seeds": 4}),
    }


def _encode(journal, side, case):
    kw = dict(case)
    instances, grid = kw.pop("instances"), kw.pop("grid")
    names, solver, robust, options, budget = (
        kw.pop(k) for k in ("names", "solver", "robust", "options",
                            "budget"))
    return journal.encode_ticket(
        side.obj(list(instances)), [side.obj(list(ps)) for ps in grid],
        names, solver, robust, options, budget, **kw)


def _assert_same_state(a, b):
    assert set(a) == set(b)
    for key in a:
        assert set(a[key]) == set(b[key]), key
        for leaf in a[key]:
            x, y = np.asarray(a[key][leaf]), np.asarray(b[key][leaf])
            assert x.dtype == y.dtype and np.array_equal(x, y), (key, leaf)


def _assert_same_decoded(a, b):
    assert tuple(a[2:]) == tuple(b[2:])
    assert (a.mapping, a.mapping_options) == (b.mapping, b.mapping_options)
    for x, y in zip(a[0], b[0]):
        assert type(x).__name__ == type(y).__name__
        for f in dataclasses.fields(x):
            vx, vy = getattr(x, f.name), getattr(y, f.name)
            if isinstance(vx, np.ndarray):
                assert vx.dtype == vy.dtype and np.array_equal(vx, vy), f
            else:
                assert vx == vy, f.name
    for ps, qs in zip(a[1], b[1]):
        for p, q in zip(ps, qs):
            assert np.array_equal(p.bounds, q.bounds)
            assert np.array_equal(p.budget, q.budget)
            assert p.scenario == q.scenario


@pytest.mark.parametrize("case", ["instance", "workflow"])
def test_journal_entries_cross_packages(case, tmp_path):
    spec = _journal_cases()[case]
    ref = _encode(r_journal, REF, spec)
    got = _encode(t_journal, PORT, spec)
    _assert_same_state(ref, got)
    assert bytes(got["meta"]["json"]) == bytes(ref["meta"]["json"])
    # written by one package, replayed by the other
    for writer, reader, side in ((r_journal, t_journal, PORT),
                                 (t_journal, r_journal, REF)):
        d = tmp_path / f"{case}-{writer.__name__}"
        writer.TicketJournal(str(d)).record(3, ref if writer is r_journal
                                            else got)
        (seq, state), = reader.TicketJournal(str(d)).pending()
        assert seq == 3
        want = (t_journal if side.port else r_journal).decode_ticket(
            got if side.port else ref)
        _assert_same_decoded(reader.decode_ticket(state), want)


def test_kill_then_restart_replays_to_direct_plan(tmp_path):
    plat, inst, prof = _setup()
    inst, prof = PORT.obj([inst, prof])
    planner = PORT.planner(plat, engine="torch")
    req = PORT.PlanRequest(instances=inst, profiles=[prof, prof])
    direct = planner.plan(req)
    jdir = str(tmp_path / "journal")
    svc = PORT.service(planner.clone(), journal_dir=jdir)
    try:
        svc.pause()
        t1, t2 = svc.submit(req), svc.submit(req)
    finally:
        svc.kill()
    assert not t1.done() and not t2.done()
    svc2 = PORT.service(planner.clone(), journal_dir=jdir, workers=2)
    try:
        assert len(svc2.replayed) == 2
        results = [t.result(timeout=120) for t in svc2.replayed]
        stats = svc2.stats()
    finally:
        svc2.close()
    assert stats["replayed"] == 2 and stats["batches"] == 1
    for r in results:
        assert_same_plan(r, direct)
        assert not r.degraded and r.attempts == ("heuristic:ok",)
    assert t_journal.TicketJournal(jdir).pending() == []


# --- budget-aware mapping fallback -------------------------------------------

DEGRADE_CASES = {
    "shrinks": (1.0, ("heuristic", "search",
                      {"seeds": 6, "rounds": 4, "neighbors": 12}, 16.0, 1)),
    "heft-when-nothing-fits": (1.0, ("heuristic", "search", None, 2.0, 1)),
    "batch-splits-budget": (1.0, ("heuristic", "search", None, 16.0, 8)),
    "capped-without-deadline": (None, ("heuristic", "search",
                                       {"seeds": 20, "rounds": 5,
                                        "neighbors": 20}, None, 1)),
    "terminal-asap": (None, ("asap", "search", {"seeds": 3}, 1e9, 1)),
    "heft-passes-through": (None, ("heuristic", "heft", None, 50.0, 1)),
    "default-ema": (None, ("ilp", "search", {"seeds": 4, "rounds": 2},
                           3.0, 1)),
}


@pytest.mark.parametrize("case", sorted(DEGRADE_CASES))
def test_degrade_mapping_matches_reference(case):
    ema, args = DEGRADE_CASES[case]
    plat, _, _ = _setup()
    out = []
    for side in (REF, PORT):
        with side.service(side.planner(plat)) as svc:
            svc._mapping_cand_ema = ema
            mode, opts = svc._degrade_mapping(*args)
            stats = svc.stats()
        out.append((mode, opts, stats["mapping_search_shrinks"],
                    stats["mapping_heft_downgrades"]))
    assert out[1] == out[0]
    mode, opts, shrinks, downgrades = out[1]
    if mode == "search" and args[2] is not None:
        assert MappingOptions.from_dict(opts).max_candidates() \
            <= MappingOptions.from_dict(args[2]).max_candidates()
    assert shrinks + downgrades <= 1


def test_mapping_budget_zero_degrades_to_asap_with_heft():
    plat = make_cluster(1, seed=0)
    wf = make_workflow("eager", 2, seed=0)
    prof = generate_profile("S3", 400, plat, J=12, seed=2, work_capacity=40)
    out = []
    for side in (REF, PORT):
        with side.service(side.planner(plat)) as svc:
            res = svc.plan(side.PlanRequest(
                instances=side.obj(wf), profiles=side.obj(prof),
                mapping="search",
                mapping_options={"seeds": 8, "rounds": 6,
                                 "neighbors": 16}), budget=0.0)
            out.append((res, script_stats(svc.stats())))
    (ref, ref_stats), (res, stats) = out
    assert res.degraded and res.fallback_stage == "asap"
    assert res.mapping_mode == "heft" and "mapping:heft" in res.attempts
    assert res.attempts == ref.attempts
    assert stats == ref_stats
    assert_same_plan(res, ref)
    assert np.array_equal(res.mappings[0].proc, ref.mappings[0].proc)
