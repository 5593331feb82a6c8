"""Port parity, Planner API end to end: repro_torch's
``Planner(engine="torch")`` against repro's ``Planner(engine="jax")``, and
numpy engine against numpy engine, bitwise in the cost tensor, the
schedules, best() and robust(); the asap solver; the request surface."""
import numpy as np
import pytest

from repro.api import Planner as RPlanner
from repro.api import PlanRequest as RRequest
from repro.cluster import make_cluster
from repro.core import (build_instance, deadline_from_asap,
                        generate_profile, heft_mapping)
from repro.workflows import make_workflow
from repro_torch import interop
from repro_torch.api import LocalSearchConfig, Planner, PlanRequest
from repro_torch.core.cancel import Cancelled, CancelToken


def _grid(kinds, scenarios, seed=0, factor=2.0):
    plat = make_cluster(1, seed=seed)
    insts, grid = [], []
    for j, kind in enumerate(kinds):
        wf = make_workflow(kind, 3, seed=seed + j)
        inst = build_instance(wf, heft_mapping(wf, plat), plat)
        T = deadline_from_asap(inst, factor)
        insts.append(inst)
        grid.append([generate_profile(s, T, plat, J=12, seed=seed + j + i)
                     for i, s in enumerate(scenarios)])
    return plat, insts, grid


def _ported(plat, insts, grid):
    return (interop.port(plat), [interop.port(i) for i in insts],
            [[interop.port(p) for p in ps] for ps in grid])


def _assert_same_plan(want, got):
    assert got.variants == want.variants
    assert got.costs.dtype == np.int64
    assert np.array_equal(want.costs, got.costs)
    I, P, _ = want.costs.shape
    for i in range(I):
        for p in range(P):
            for n in want.variants:
                assert np.array_equal(want.results[i][p][n].start,
                                      got.results[i][p][n].start), (i, p, n)
            assert want.best(i, p).variant == got.best(i, p).variant
        assert want.robust(i) == got.robust(i)
    assert np.array_equal(want.best_costs(), got.best_costs())
    ws, gs = want.summary_dict(), got.summary_dict()
    for key in ("variants", "costs", "solver", "robust_requested"):
        assert ws[key] == gs[key], key


@pytest.mark.parametrize("engines", [("jax", "torch"), ("numpy", "numpy")])
@pytest.mark.parametrize("shape", ["1x1x17", "2x2x17"])
def test_plan_matches_reference(shape, engines):
    kinds, scens = {"1x1x17": (("eager",), ("S3",)),
                    "2x2x17": (("bacass", "methylseq"), ("S1", "S4"))}[shape]
    plat, insts, grid = _grid(kinds, scens)
    want = RPlanner(plat, engine=engines[0]).plan(
        RRequest(instances=insts, profiles=grid))
    tplat, tinsts, tgrid = _ported(plat, insts, grid)
    got = Planner(tplat, engine=engines[1], device="cpu").plan(
        PlanRequest(instances=tinsts, profiles=tgrid))
    assert got.engine == engines[1]
    assert got.costs.shape == (len(kinds), len(scens), 17)
    _assert_same_plan(want, got)


def test_plan_with_auto_commit_and_deadline_scale_matches_reference():
    plat, insts, grid = _grid(("atacseq",), ("S2", "S3"), seed=5,
                              factor=3.0)
    ls = dict(mu=6, max_rounds=50, commit_k="auto")
    from repro.api import LocalSearchConfig as RLS
    want = RPlanner(plat, engine="jax", ls=RLS(**ls)).plan(
        RRequest(instances=insts, profiles=grid, deadline_scale=1.5))
    tplat, tinsts, tgrid = _ported(plat, insts, grid)
    got = Planner(tplat, engine="torch", ls=LocalSearchConfig(**ls),
                  device="cpu").plan(
        PlanRequest(instances=tinsts, profiles=tgrid, deadline_scale=1.5))
    _assert_same_plan(want, got)


def test_asap_solver_matches_reference():
    plat, insts, grid = _grid(("eager", "atacseq"), ("S1", "S2"))
    want = RPlanner(plat).plan(RRequest(instances=insts, profiles=grid,
                                        solver="asap"))
    tplat, tinsts, tgrid = _ported(plat, insts, grid)
    got = Planner(tplat, device="cpu").plan(
        PlanRequest(instances=tinsts, profiles=tgrid, solver="asap"))
    assert got.variants == want.variants == ("asap",)
    assert np.array_equal(want.costs, got.costs)
    for i in range(2):
        for p in range(2):
            assert np.array_equal(want.results[i][p]["asap"].start,
                                  got.results[i][p]["asap"].start)


def test_engine_auto_follows_reference_rule():
    plat, insts, grid = _grid(("bacass",), ("S1", "S2"))
    tplat, tinsts, tgrid = _ported(plat, insts, grid)
    planner = Planner(tplat, device="cpu")
    one = planner.plan(PlanRequest(instances=tinsts[0],
                                   profiles=tgrid[0][0],
                                   variants=("pressW",)))
    two = planner.plan(PlanRequest(instances=tinsts, profiles=tgrid,
                                   variants=("pressW",)))
    assert (one.engine, two.engine) == ("numpy", "torch")
    assert one.costs[0, 0, 0] == two.costs[0, 0, 0]
    assert set(two.phase_seconds) >= {"greedy", "graphs"}
    clone = planner.clone(engine="numpy")
    assert clone.device == planner.device and clone.engine == "numpy"


def test_request_surface_limits_of_this_slice():
    plat, insts, grid = _grid(("eager",), ("S1",))
    tplat, tinsts, tgrid = _ported(plat, insts, grid)
    planner = Planner(tplat, engine="torch", device="cpu")
    with pytest.raises(ValueError, match="mapping='heft' is not yet ported"):
        planner.plan(PlanRequest(instances=tinsts, profiles=tgrid,
                                 mapping="heft"))
    with pytest.raises(ValueError, match="devices=2 is not yet ported"):
        planner.plan(PlanRequest(instances=tinsts, profiles=tgrid,
                                 devices=2))
    for solver in ("exact", "ilp", "dp"):
        with pytest.raises(ValueError, match="not yet ported"):
            planner.plan(PlanRequest(instances=tinsts, profiles=tgrid,
                                     solver=solver))
    with pytest.raises(ValueError, match="unknown variant"):
        planner.plan(PlanRequest(instances=tinsts, profiles=tgrid,
                                 variants=("nope",)))
    with pytest.raises(ValueError, match="unknown engine"):
        Planner(tplat, engine="jax", device="cpu")
    single = planner.plan(PlanRequest(instances=tinsts, profiles=tgrid,
                                      devices=1, variants="slack-LS"))
    assert single.costs.shape == (1, 1, 1)


def test_cancelled_plan_raises():
    plat, insts, grid = _grid(("eager",), ("S1", "S2"))
    tplat, tinsts, tgrid = _ported(plat, insts, grid)
    token = CancelToken()
    token.cancel("test")
    with pytest.raises(Cancelled):
        Planner(tplat, engine="torch", device="cpu").plan(
            PlanRequest(instances=tinsts, profiles=tgrid), cancel=token)
    assert token.checks >= 1
