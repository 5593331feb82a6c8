"""Port parity, the chaos suite: every tests/test_chaos.py drill run through
repro_torch's PlanService (on the CPU) and through repro's on the same
script, with the same acceptance properties, and with each ticket's
``attempts`` log equal to the reference's. The one drill whose logs depend
on the worker pool's interleaving (the full fault matrix) is held to the
properties both packages guarantee: its counts of quarantined, served and
failed tickets.

Marked ``chaos`` (deselected from tier-1 via addopts): ``pytest -m chaos
tests/test_torch_chaos.py --chaos-workers 1`` (and ``4``); ``--chaos-seed
N`` offsets the scenario seeds. Every wait is bounded.
"""
import time

import pytest

from repro.cluster import make_cluster
from repro.core import build_instance, deadline_from_asap, generate_profile, \
    heft_mapping
from repro.workflows import make_workflow
from repro_torch.core import validate_schedule
from test_torch_service import PORT, REF, _setup, assert_same_plan

pytestmark = pytest.mark.chaos


def _feasible(res, inst, prof):
    """Whatever the ladder returned, it is a feasible schedule."""
    for name in res.variants:
        validate_schedule(PORT.obj(inst), PORT.obj(prof),
                          res.result(variant=name).start)


def _both(script, *args):
    """``script(side, *args)`` on the reference, then on the port; returns
    both outcomes."""
    return script(REF, *args), script(PORT, *args)


def _single(side, faults, request_kw, workers, budget=None, **svc_kw):
    plat, inst, prof = _setup()
    planner = side.planner(plat)
    inj = side.Injector(faults=[side.FaultSpec(**f) for f in faults])
    with side.service(planner.clone(), injector=inj, workers=workers,
                      **svc_kw) as svc:
        t0 = time.monotonic()
        res = svc.plan(side.PlanRequest(instances=side.obj(inst),
                                        profiles=side.obj(prof),
                                        **request_kw), budget=budget)
        elapsed = time.monotonic() - t0
        stats = svc.stats()
    return res, stats, inj.fired, elapsed, svc.fallback_variants


# --- single-fault ladder walks -----------------------------------------------

SINGLE = {
    "persistent-crash": dict(
        faults=[dict(kind="crash", stage="ilp", times=99)],
        request_kw=dict(solver="ilp"), svc_kw=dict(retries=1, backoff=0.01),
        attempts=("ilp:crash", "ilp:crash", "heuristic:ok")),
    "hang-trips-watchdog": dict(
        faults=[dict(kind="hang", stage="heuristic", times=5, seconds=2.0)],
        request_kw={}, budget=0.3, svc_kw={},
        attempts=("heuristic:timeout", "asap:ok")),
    "double-oom": dict(
        faults=[dict(kind="oom", stage="heuristic", times=2)],
        request_kw={}, svc_kw={},
        attempts=("heuristic:oom", "heuristic:oom-retry-blocked-lp",
                  "heuristic:oom", "asap:ok")),
    "exact-walks-every-rung": dict(
        faults=[dict(kind="crash", stage="exact", times=9),
                dict(kind="crash", stage="ilp", times=9)],
        request_kw=dict(solver="exact"), svc_kw=dict(retries=0),
        attempts=("exact:crash", "ilp:crash", "heuristic:ok")),
    "budget-blown-mid-chain": dict(
        faults=[dict(kind="hang", stage="exact", times=1, seconds=2.0)],
        request_kw=dict(solver="exact"), budget=0.25, svc_kw={},
        attempts=("exact:timeout", "ilp:skipped", "heuristic:skipped",
                  "asap:ok")),
}


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_fault_ladder_walk(name, chaos_workers):
    case = SINGLE[name]
    out = _both(lambda side: _single(
        side, case["faults"], case["request_kw"], chaos_workers,
        budget=case.get("budget"), **case["svc_kw"]))
    (ref, _, ref_fired, _, _), (res, stats, fired, elapsed, fb) = out
    assert res.attempts == ref.attempts == case["attempts"]
    assert res.degraded and res.fallback_stage == ref.fallback_stage
    assert fired == ref_fired
    assert_same_plan(res, ref)
    plat, inst, prof = _setup()
    _feasible(res, inst, prof)
    if name == "persistent-crash":
        assert res.variants == fb
        assert fired == [("crash", "ilp")] * 2
    if name == "hang-trips-watchdog":
        assert elapsed < 1.5, elapsed       # abandoned at ~budget, not 2 s
    if name == "double-oom":
        assert stats["oom_retries"] == 1


def test_crash_on_every_stage_is_a_structured_failure(chaos_workers):
    def script(side):
        plat, inst, prof = _setup()
        inj = side.Injector(
            faults=[side.FaultSpec(kind="crash", stage=None, times=99)])
        with side.service(side.planner(plat), injector=inj, retries=0,
                          backoff=0.01, workers=chaos_workers) as svc:
            with pytest.raises(side.serve.PlanFailure) as ei:
                svc.plan(side.PlanRequest(instances=side.obj(inst),
                                          profiles=side.obj(prof)))
            failed = svc.stats()["failed"]
        return ei.value.to_dict(), failed

    (ref, ref_failed), (got, failed) = _both(script)
    assert got == ref
    assert failed == ref_failed == 1
    assert got["code"] == "plan_failure"
    assert got["attempts"] == ["heuristic:crash", "asap:crash"]


# --- quarantine isolation ----------------------------------------------------

def test_corrupt_request_is_quarantined_batch_survives(chaos_workers):
    def script(side):
        plat, inst, prof = _setup()
        inst, prof = side.obj([inst, prof])
        planner = side.planner(plat)
        direct = planner.plan(side.PlanRequest(instances=inst,
                                               profiles=prof))
        inj = side.Injector(faults=[side.FaultSpec(kind="corrupt",
                                                   times=1)])
        with side.service(planner.clone(), injector=inj,
                          workers=chaos_workers) as svc:
            svc.pause()
            ts = [svc.submit(side.PlanRequest(instances=inst,
                                              profiles=prof))
                  for _ in range(3)]
            svc.resume()
            with pytest.raises(side.serve.InvalidRequest,
                               match="batch assembly") as ei:
                ts[0].result(timeout=120)
            served = [t.result(timeout=120) for t in ts[1:]]
            stats = svc.stats()
        for r in served:
            assert_same_plan(r, direct)
            assert not r.degraded
        assert stats["quarantined"] == 1
        assert stats["batches"] == 1 and stats["coalesced_requests"] == 2
        return ei.value.to_dict(), [r.attempts for r in served]

    ref, got = _both(script)
    assert got == ref


def test_poison_error_bisects_batch_each_ticket_rechains_alone(
        chaos_workers):
    def script(side):
        plat, inst, prof = _setup(samples=2, seed=5)
        wf2 = make_workflow("eager", 2, seed=9)
        plat2 = make_cluster(1, seed=5)
        inst2 = build_instance(wf2, heft_mapping(wf2, plat2), plat2)
        prof2 = generate_profile("S1", deadline_from_asap(inst2, 1.5),
                                 plat2, J=16, seed=7)
        inst, prof, inst2, prof2 = side.obj([inst, prof, inst2, prof2])
        planner = side.planner(plat)
        reqs = [side.PlanRequest(instances=inst, profiles=prof),
                side.PlanRequest(instances=inst2, profiles=prof2)]
        direct = [planner.plan(r) for r in reqs]
        inj = side.Injector(faults=[side.FaultSpec(
            kind="error", stage="heuristic", times=1)])
        with side.service(planner.clone(), injector=inj,
                          workers=chaos_workers) as svc:
            svc.pause()
            ts = [svc.submit(r) for r in reqs]
            svc.resume()
            served = [t.result(timeout=120) for t in ts]
            assert svc.stats()["splits"] == 1
        for r, d in zip(served, direct):
            assert r.attempts[0] == "quarantine:split"
            assert r.attempts[-1] == "heuristic:ok"
            assert not r.degraded
            assert_same_plan(r, d)
        return [r.attempts for r in served]

    ref, got = _both(script)
    assert got == ref


def test_persistent_poison_degrades_every_split_ticket_to_asap(
        chaos_workers):
    def script(side):
        plat, inst, prof = _setup()
        inj = side.Injector(faults=[side.FaultSpec(
            kind="error", stage="heuristic", times=99)])
        with side.service(side.planner(plat), injector=inj,
                          workers=chaos_workers) as svc:
            svc.pause()
            ts = [svc.submit(side.PlanRequest(instances=side.obj(inst),
                                              profiles=side.obj(prof)))
                  for _ in range(2)]
            svc.resume()
            served = [t.result(timeout=120) for t in ts]
        for r in served:
            assert r.degraded and r.fallback_stage == "asap"
            _feasible(r, inst, prof)
        return [r.attempts for r in served]

    ref, got = _both(script)
    assert got == ref
    assert got == [("quarantine:split", "heuristic:error", "asap:ok")] * 2


# --- seeded probabilistic sweep ----------------------------------------------

def test_seeded_random_crash_sweep_always_yields_feasible_plans(
        chaos_workers, chaos_seed):
    def script(side):
        plat, inst, prof = _setup(seed=3 + chaos_seed)
        planner = side.planner(plat)
        runs = []
        for _ in range(2):
            inj = side.Injector(prob=0.35, seed=1234 + chaos_seed)
            with side.service(planner.clone(), injector=inj, retries=3,
                              backoff=0.01, workers=chaos_workers) as svc:
                results = [svc.plan(side.PlanRequest(
                    instances=side.obj(inst), profiles=side.obj(prof)))
                    for _ in range(6)]
                stats = svc.stats()
            assert stats["completed"] == 6 and stats["failed"] == 0
            assert inj.fired, "seed produced no faults"
            for r in results:
                assert r.fallback_stage in ("heuristic", "asap")
                assert r.degraded == (r.fallback_stage != "heuristic")
                _feasible(r, inst, prof)
            runs.append((inj.fired, results))
        (f1, r1), (f2, r2) = runs
        assert f1 == f2                     # scripted RNG: same faults
        for a, b in zip(r1, r2):
            assert a.attempts == b.attempts
            assert_same_plan(a, b)
        return f1, r1

    (ref_fired, ref), (fired, got) = _both(script)
    assert fired == ref_fired
    for a, b in zip(ref, got):
        assert b.attempts == a.attempts
        assert_same_plan(a, b)


# --- worker supervision ------------------------------------------------------

@pytest.mark.parametrize("kind,seconds", [("worker-death", 0.25),
                                          ("wedge", 30.0)])
def test_worker_fault_restarts_and_requeues(kind, seconds, chaos_workers):
    def script(side):
        plat, inst, prof = _setup()
        inst, prof = side.obj([inst, prof])
        planner = side.planner(plat)
        direct = planner.plan(side.PlanRequest(instances=inst,
                                               profiles=prof))
        inj = side.Injector(faults=[side.FaultSpec(kind=kind, times=1,
                                                   seconds=seconds)])
        with side.service(planner.clone(), injector=inj,
                          workers=chaos_workers,
                          heartbeat_timeout=0.2) as svc:
            t0 = time.monotonic()
            t = svc.submit(side.PlanRequest(instances=inst, profiles=prof))
            res = t.result(timeout=60)      # served by the replacement
            elapsed = time.monotonic() - t0
            stats = svc.stats()
        assert elapsed < 10.0, elapsed      # not after a 30 s stall
        assert_same_plan(res, direct)
        assert not res.degraded
        assert stats["worker_restarts"] >= 1 and stats["requeued"] >= 1
        assert (kind, None) in inj.fired
        return res.attempts

    ref, got = _both(script)
    assert got == ref == ("heuristic:ok",)


def test_mid_burst_kill_replays_journal_without_losing_tickets(
        tmp_path, chaos_workers):
    def script(side):
        plat, inst, prof = _setup()
        inst, prof = side.obj([inst, prof])
        planner = side.planner(plat)
        req = side.PlanRequest(instances=inst, profiles=prof)
        direct = planner.plan(req)
        jdir = str(tmp_path / f"journal-{side.port}")
        inj = side.Injector(faults=[side.FaultSpec(kind="kill", times=1)])
        svc = side.service(planner.clone(), injector=inj,
                           workers=chaos_workers, journal_dir=jdir)
        try:
            svc.pause()
            tickets = [svc.submit(req) for _ in range(5)]
            svc.resume()                # the first claim kills the service
            deadline = time.monotonic() + 30
            while not svc._killed and time.monotonic() < deadline:
                time.sleep(0.01)
            assert svc._killed
        finally:
            svc.kill()
        assert sum(not t.done() for t in tickets) == 5
        svc2 = side.service(planner.clone(), workers=chaos_workers,
                            journal_dir=jdir)
        try:
            assert len(svc2.replayed) == 5
            results = [t.result(timeout=120) for t in svc2.replayed]
            stats2 = svc2.stats()
        finally:
            svc2.close()
        for r in results:
            assert_same_plan(r, direct)
            assert not r.degraded
        assert stats2["replayed"] == 5 and stats2["completed"] == 5
        svc3 = side.service(planner.clone(), workers=chaos_workers,
                            journal_dir=jdir)
        try:
            assert svc3.replayed == []      # each resolved exactly once
        finally:
            svc3.close()
        return [r.attempts for r in results]

    ref, got = _both(script)
    assert got == ref


def test_full_fault_matrix_under_worker_pool_always_feasible(
        chaos_workers, chaos_seed):
    """Every fault kind at once against one burst: whatever the pool's
    interleaving, every ticket resolves feasibly or with a structured
    quarantine, and nothing ends in PlanFailure — in both packages."""
    def script(side):
        plat, inst, prof = _setup(seed=3 + chaos_seed)
        inj = side.Injector(faults=[side.FaultSpec(**f) for f in (
            dict(kind="crash", stage="heuristic", times=2),
            dict(kind="hang", stage="heuristic", times=1, seconds=2.0),
            dict(kind="oom", stage="heuristic", times=1),
            dict(kind="error", stage="heuristic", times=1),
            dict(kind="corrupt", times=1),
            dict(kind="worker-death", times=1),
            dict(kind="wedge", times=1, seconds=30.0))])
        with side.service(side.planner(plat), injector=inj,
                          workers=chaos_workers, heartbeat_timeout=0.25,
                          retries=1, backoff=0.01,
                          default_budget=2.0) as svc:
            tickets = [svc.submit(side.PlanRequest(
                instances=side.obj(inst), profiles=side.obj(prof)))
                for _ in range(10)]
            quarantined, served = 0, []
            for t in tickets:
                try:
                    served.append(t.result(timeout=120))
                except side.serve.InvalidRequest:
                    quarantined += 1
            failed = svc.stats()["failed"]
        for r in served:
            _feasible(r, inst, prof)
        return quarantined, len(served), failed

    ref, got = _both(script)
    assert got == ref == (1, 9, 0)


def test_fault_free_multi_worker_bit_identical_to_single_worker():
    plat, inst, prof = _setup()
    inst, prof = PORT.obj([inst, prof])
    planner = PORT.planner(plat)
    req = PORT.PlanRequest(instances=inst, profiles=prof)
    direct = planner.plan(req)

    def burst(workers):
        with PORT.service(planner.clone(), workers=workers) as svc:
            svc.pause()
            tickets = [svc.submit(req) for _ in range(6)]
            svc.resume()
            return [t.result(timeout=120) for t in tickets]

    multi, solo = burst(4), burst(1)
    for a, b in zip(multi, solo):
        assert_same_plan(a, b)
        assert_same_plan(a, direct)
        assert not a.degraded


# --- fault-free control ------------------------------------------------------

def test_fault_free_mixed_workload_bit_identical_to_direct(chaos_workers):
    def script(side):
        plat, inst, prof = _setup()
        inst, prof = side.obj([inst, prof])
        planner = side.planner(plat)
        reqs = [
            side.PlanRequest(instances=inst, profiles=prof),
            side.PlanRequest(instances=inst, profiles=prof, robust=True),
            side.PlanRequest(instances=inst, profiles=prof, solver="asap"),
            side.PlanRequest(instances=inst, profiles=prof,
                             variants=("slack", "pressWR-LS")),
        ]
        direct = [planner.plan(r) for r in reqs]
        with side.service(planner.clone(), workers=chaos_workers) as svc:
            svc.pause()
            tickets = [svc.submit(r) for r in reqs]
            svc.resume()
            served = [t.result(timeout=120) for t in tickets]
            stats = svc.stats()
        for s, d in zip(served, direct):
            assert_same_plan(s, d)
            assert not s.degraded
        assert stats["degraded"] == 0 and stats["completed"] == 4
        return served

    ref, got = _both(script)
    for a, b in zip(ref, got):
        assert b.attempts == a.attempts
        assert_same_plan(a, b)
