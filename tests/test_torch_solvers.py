"""Port parity, the exact solver axis: repro_torch's ``dp``, ``ilp`` and
``exact`` solvers through ``Planner(..., device="cpu").plan(solver=...)``
against repro's, for costs, lower bounds, ``gap()``, ``mip_gap`` and
starts, bitwise; and the ported DP/ILP functions against repro's on the
cases of tests/test_dp_ilp.py."""
import numpy as np
import pytest

from repro.api import Planner as RPlanner
from repro.api import PlanRequest as RRequest
from repro.cluster import make_cluster
from repro.core import (build_instance, deadline_from_asap, generate_profile,
                        heft_mapping)
from repro.core.carbon import PowerProfile
from repro.core.dag import trivial_mapping
from repro.core.dp_uniproc import dp_poly as r_dp_poly
from repro.core.dp_uniproc import dp_pseudo as r_dp_pseudo
from repro.workflows import layered_random, make_workflow
from repro_torch import interop
from repro_torch.api import Planner, PlanRequest
from repro_torch.core import get_solver, solver_names, validate_schedule
from repro_torch.core.cancel import Cancelled, CancelToken
from repro_torch.core.dp_uniproc import dp_poly, dp_pseudo, is_uniprocessor
from repro_torch.kernels.backend import resolve_solver


def _require_highs():
    opt = pytest.importorskip("scipy.optimize")
    if not hasattr(opt, "milp"):
        pytest.skip("scipy.optimize.milp (HiGHS) unavailable")


def _tight_profile(inst, plat, T, J=4, seed=0):
    """tests/test_solvers.py's budget: tight enough that scheduling
    decisions carry nonzero cost."""
    rng = np.random.default_rng(seed)
    bounds = np.unique(np.round(np.linspace(0, T, J + 1)).astype(np.int64))
    budget = plat.idle_total + rng.integers(
        0, max(int(inst.task_work.max()) // 2, 2), size=len(bounds) - 1)
    return PowerProfile(bounds=bounds, budget=budget)


def _uniproc(seed=7, factor=1.4):
    plat = make_cluster(1, seed=0)
    wf = layered_random(5, 3, seed=seed)
    inst = build_instance(wf, trivial_mapping(wf, plat, by="single"), plat)
    T = deadline_from_asap(inst, factor)
    return plat, inst, _tight_profile(inst, plat, T, seed=seed)


def _multiproc(seed=0, factor=1.5):
    rng = np.random.default_rng(seed)
    plat = make_cluster(1, seed=0)
    wf = layered_random(6, 3, seed=seed)
    inst = build_instance(wf, trivial_mapping(wf, plat), plat,
                          dur=rng.integers(1, 6, size=wf.n))
    T = deadline_from_asap(inst, factor)
    return plat, inst, _tight_profile(inst, plat, T, seed=seed)


def _both(plat, insts, grid, solver, options=None, engine="numpy"):
    """One request through repro's Planner and the port's, on the CPU."""
    want = RPlanner(plat, engine=engine).plan(RRequest(
        instances=insts, profiles=grid, solver=solver,
        solver_options=options))
    got = Planner(interop.port(plat), engine="numpy", device="cpu").plan(
        PlanRequest(instances=[interop.port(i) for i in insts],
                    profiles=[[interop.port(p) for p in ps] for ps in grid],
                    solver=solver, solver_options=options))
    return want, got


def _assert_same_exact(want, got):
    assert got.solver == want.solver and got.variants == want.variants
    assert got.costs.dtype == np.int64
    assert np.array_equal(got.costs, want.costs)
    for field in ("lower_bound", "mip_gap"):
        a, b = getattr(want, field), getattr(got, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.array_equal(a, b, equal_nan=True), field
    I, P, _ = want.costs.shape
    for i in range(I):
        for p in range(P):
            for n in want.variants:
                assert np.array_equal(want.results[i][p][n].start,
                                      got.results[i][p][n].start), (i, p, n)


def test_solver_registry_resolution():
    assert set(solver_names()) >= {"heuristic", "exact", "ilp", "dp",
                                   "asap"}
    assert resolve_solver(None).name == "heuristic"
    assert resolve_solver("exact") is get_solver("exact")
    assert not get_solver("dp").uses_graphs
    with pytest.raises(ValueError, match="unknown solver"):
        resolve_solver("simplex")
    plat, inst, prof = _uniproc()
    pinst, pprof = interop.port(inst), interop.port(prof)
    with pytest.raises(ValueError, match="exactly the variant"):
        PlanRequest(instances=pinst, profiles=pprof, solver="exact",
                    variants=("slack",)).resolve()
    _, _, names = PlanRequest(instances=pinst, profiles=pprof,
                              solver="exact").resolve()
    assert names == ("exact",)


@pytest.mark.parametrize("seed", range(3))
def test_exact_and_dp_on_uniprocessor_match_reference(seed):
    plat, inst, prof = _uniproc(seed=seed)
    want, got = _both(plat, [inst], [[prof]], "exact", {"check": True})
    _assert_same_exact(want, got)
    assert is_uniprocessor(interop.port(inst))
    c_poly, _ = r_dp_poly(inst, prof)
    assert int(got.costs[0, 0, 0]) == int(got.lower_bound[0, 0]) == c_poly
    assert got.mip_gap is None
    want, got = _both(plat, [inst], [[prof]], "dp")
    _assert_same_exact(want, got)
    # the heuristic-vs-optimal ratio, on the port's own grid
    planner = Planner(interop.port(plat), engine="numpy", device="cpu")
    heur = planner.plan(PlanRequest(instances=interop.port(inst),
                                    profiles=interop.port(prof)))
    rheur = RPlanner(plat, engine="numpy").plan(
        RRequest(instances=inst, profiles=prof))
    assert np.array_equal(heur.gap(got), rheur.gap(want))
    assert heur.gap(got)[0, 0] >= 1.0 - 1e-12


def test_dp_solver_rejects_multiprocessor():
    plat, inst, prof = _multiproc()
    with pytest.raises(ValueError, match="single-processor"):
        Planner(interop.port(plat), engine="numpy", device="cpu").plan(
            PlanRequest(instances=interop.port(inst),
                        profiles=interop.port(prof), solver="dp"))


@pytest.mark.ilp
@pytest.mark.parametrize("seed", range(2))
def test_ilp_equals_dp_on_uniprocessor_matches_reference(seed):
    _require_highs()
    plat, inst, prof = _uniproc(seed=seed + 20)
    want, got = _both(plat, [inst], [[prof]], "ilp", {"time_limit": 120})
    _assert_same_exact(want, got)
    _, dp = _both(plat, [inst], [[prof]], "dp")
    assert int(got.costs[0, 0, 0]) == int(dp.costs[0, 0, 0]) \
        == int(got.lower_bound[0, 0])


@pytest.mark.ilp
@pytest.mark.parametrize("seed", range(2))
def test_exact_on_multiprocessor_matches_reference(seed):
    _require_highs()
    plat, inst, prof = _multiproc(seed=seed)
    want, got = _both(plat, [inst], [[prof]], "exact", {"time_limit": 120})
    _assert_same_exact(want, got)
    tplat, tinst, tprof = map(interop.port, (plat, inst, prof))
    validate_schedule(tinst, tprof, got.result(variant="exact").start)
    planner = Planner(tplat, engine="torch", device="cpu")
    heur = planner.plan(PlanRequest(instances=tinst, profiles=tprof))
    base = planner.plan(PlanRequest(instances=tinst, profiles=tprof,
                                    solver="asap"))
    opt = int(got.costs[0, 0, 0])
    assert (heur.costs[0, 0] >= opt).all()
    assert int(base.costs[0, 0, 0]) >= opt
    rheur = RPlanner(plat, engine="numpy").plan(
        RRequest(instances=inst, profiles=prof))
    pheur = Planner(tplat, engine="numpy", device="cpu").plan(
        PlanRequest(instances=tinst, profiles=tprof))
    assert np.array_equal(pheur.gap(got), rheur.gap(want))
    assert "exact" in pheur.compare(got)


def test_gap_requires_bound_and_handles_zero_cost():
    plat, inst, prof = _uniproc(seed=3)
    tplat, tinst, tprof = map(interop.port, (plat, inst, prof))
    planner = Planner(tplat, engine="numpy", device="cpu")
    heur = planner.plan(PlanRequest(instances=tinst, profiles=tprof))
    with pytest.raises(ValueError, match="lower bound"):
        heur.gap()
    _, ex = _both(plat, [inst], [[prof]], "exact")
    assert heur.gap(ex)[0, 0] >= 1.0 - 1e-12
    free = PowerProfile(
        bounds=np.asarray([0, prof.T], dtype=np.int64),
        budget=np.asarray([plat.idle_total + int(inst.task_work.sum()) + 1],
                          dtype=np.int64))
    want, e0 = _both(plat, [inst], [[free]], "exact")
    _assert_same_exact(want, e0)
    h0 = planner.plan(PlanRequest(instances=tinst,
                                  profiles=interop.port(free)))
    assert int(e0.costs[0, 0, 0]) == 0 and h0.gap(e0)[0, 0] == 1.0


@pytest.mark.ilp
def test_exact_dispatches_per_instance_in_one_request():
    _require_highs()
    plat, uni, prof_u = _uniproc(seed=4)
    _, multi, prof_m = _multiproc(seed=2)
    want, got = _both(plat, [uni, multi], [[prof_u], [prof_m]], "exact",
                      {"time_limit": 120})
    _assert_same_exact(want, got)
    assert got.shape == (2, 1, 1)
    assert np.isnan(got.mip_gap[0, 0]) and got.mip_gap[1, 0] == 0.0
    assert (got.lower_bound == got.costs[:, :, 0]).all()


def test_exact_observes_a_cancelled_token():
    plat, inst, prof = _uniproc(seed=1)
    token = CancelToken()
    token.cancel("test")
    with pytest.raises(Cancelled):
        Planner(interop.port(plat), device="cpu").plan(
            PlanRequest(instances=interop.port(inst),
                        profiles=interop.port(prof), solver="exact"),
            cancel=token)
    assert token.checks >= 1


# --- the DP / ILP functions, on tests/test_dp_ilp.py's cases ---------------

@pytest.mark.parametrize("seed", range(4))
def test_dp_functions_match_reference(seed):
    rng = np.random.default_rng(seed)
    plat = make_cluster(1, seed=seed)
    wf = layered_random(4, 3, seed=seed)
    inst = build_instance(wf, trivial_mapping(wf, plat, by="single"), plat)
    T = deadline_from_asap(inst, 1.0) + 4
    bounds = np.round(np.linspace(0, T, 4)).astype(np.int64)
    budget = plat.idle_total + rng.integers(
        0, int(inst.task_work.max()) + 5, size=3)
    prof = PowerProfile(bounds=bounds, budget=budget)
    tinst, tprof = interop.port(inst), interop.port(prof)
    for mine, ref in ((dp_pseudo, r_dp_pseudo), (dp_poly, r_dp_poly)):
        c, s = mine(tinst, tprof)
        rc, rs = ref(inst, prof)
        assert c == rc and np.array_equal(s, rs)


@pytest.mark.ilp
def test_solve_ilp_matches_reference_on_uniprocessor():
    """tests/test_dp_ilp.py::test_ilp_equals_dp_uniproc's first case (the
    solver-axis tests above cover further uniprocessor seeds)."""
    _require_highs()
    from repro.core.ilp import solve_ilp as r_solve_ilp
    from repro_torch.core.ilp import solve_ilp

    seed = 0
    rng = np.random.default_rng(seed + 100)
    plat = make_cluster(1, seed=seed)
    wf = layered_random(5, 3, seed=seed + 7)
    inst = build_instance(wf, trivial_mapping(wf, plat, by="single"), plat)
    T = deadline_from_asap(inst, 1.4)
    bounds = np.round(np.linspace(0, T, 5)).astype(np.int64)
    budget = plat.idle_total + rng.integers(
        0, int(inst.task_work.max()) + 10, size=4)
    prof = PowerProfile(bounds=bounds, budget=budget)
    want = r_solve_ilp(inst, prof, time_limit=120)
    got = solve_ilp(interop.port(inst), interop.port(prof), time_limit=120)
    assert got.cost == want.cost and got.status == want.status
    assert np.array_equal(got.start, want.start)
    assert got.lower_bound == want.lower_bound
    assert np.array_equal(got.mip_gap, want.mip_gap, equal_nan=True)
    assert abs(got.cost - r_dp_pseudo(inst, prof)[0]) < 1e-6


@pytest.mark.ilp
def test_solve_ilp_matches_reference_on_multiprocessor():
    """tests/test_dp_ilp.py::test_ilp_lower_bounds_heuristics's case."""
    _require_highs()
    from repro.core.ilp import solve_ilp as r_solve_ilp
    from repro_torch.core.ilp import solve_ilp

    plat = make_cluster(1, seed=0)
    wf = make_workflow("bacass", 2, seed=7)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, 1.5)
    prof = generate_profile("S1", T, plat, J=8, seed=1)
    want = r_solve_ilp(inst, prof, time_limit=180)
    got = solve_ilp(interop.port(inst), interop.port(prof), time_limit=180)
    assert got.cost == want.cost and got.status == want.status
    assert np.array_equal(got.start, want.start)
    assert got.lower_bound == want.lower_bound
