"""Port parity, rolling-horizon replanning: repro_torch's window_profile
against repro's, and a three-window PlanningSession on the CPU against
eager port plans of the same windows and against repro's session,
bitwise (tests/test_planner_api.py's session cases)."""
import threading
import time

import numpy as np
import pytest

from repro.api import Planner as RPlanner
from repro.api import window_profile as r_window_profile
from repro.cluster import make_cluster
from repro.core import (build_instance, deadline_from_asap, generate_profile,
                        heft_mapping)
from repro.workflows import make_workflow
from repro_torch import interop
from repro_torch.api import (Planner, PlanningSession, PlanRequest,
                             window_profile)
from repro_torch.core.cancel import Cancelled


def _setup(samples=3, seed=3, factor=1.6):
    plat = make_cluster(1, seed=seed)
    wf = make_workflow("eager", samples, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    return plat, inst, deadline_from_asap(inst, factor)


def test_window_profile_matches_reference():
    plat, inst, W = _setup(samples=5, factor=1.5)
    long = generate_profile("S1", 3 * W + 5, plat, J=40, seed=13)
    tlong = interop.port(long)
    for t0 in (0, 1, W, 2 * W + 3):
        want = r_window_profile(long, t0, W)
        got = window_profile(tlong, t0, W)
        assert got.T == W
        assert np.array_equal(got.bounds, want.bounds)
        assert np.array_equal(got.budget, want.budget)
        assert got.bounds.dtype == want.bounds.dtype == np.int64
        for idle in (0, plat.idle_total, 7):
            assert np.array_equal(got.unit_budget(idle),
                                  tlong.unit_budget(idle)[t0:t0 + W])
    for t0, T in ((3 * W, W + 6), (-1, W), (0, 0)):
        with pytest.raises(ValueError):
            r_window_profile(long, t0, T)
        with pytest.raises(ValueError):
            window_profile(tlong, t0, T)


def _windows(plat, W, n_windows=3):
    """The session fixture of tests/test_planner_api.py: window k is the
    k-th slice of a long forecast plus two fresh ensemble members."""
    long = generate_profile("S3", n_windows * W, plat, J=48, seed=7)
    return [[r_window_profile(long, k * W, W)]
            + [generate_profile("S3", W, plat, J=16, seed=50 + 10 * k + j)
               for j in range(2)] for k in range(n_windows)]


def _assert_same(want, got):
    assert np.array_equal(want.costs, got.costs)
    for p in range(want.shape[1]):
        for name in want.variants:
            assert np.array_equal(want.results[0][p][name].start,
                                  got.results[0][p][name].start), (p, name)
    assert want.pick(0).variant == got.pick(0).variant
    assert want.robust(0) == got.robust(0)


@pytest.mark.parametrize("engines", [("numpy", "numpy"), ("jax", "torch")])
def test_session_three_windows_match_eager_and_reference(engines):
    plat, inst, W = _setup()
    windows = _windows(plat, W)
    with RPlanner(plat, engine=engines[0]).session(
            inst, windows, n_windows=3) as rsess:
        want = [rsess.plan_for(k) for k in range(3)]
    tplat, tinst = interop.port(plat), interop.port(inst)
    twin = [[interop.port(p) for p in ps] for ps in windows]
    planner = Planner(tplat, engine=engines[1], device="cpu")
    with planner.session(tinst, twin, n_windows=3) as sess:
        got = [sess.plan_for(k) for k in range(3)]
    eager = Planner(tplat, engine=engines[1], device="cpu")
    for k in range(3):
        assert got[k].engine == engines[1]
        _assert_same(want[k], got[k])
        ref = eager.plan(PlanRequest(instances=tinst, profiles=twin[k],
                                     robust=True))
        _assert_same(ref, got[k])


def test_session_prefetches_and_bounds_windows():
    plat, inst, W = _setup()
    twin = [[interop.port(p) for p in ps] for ps in _windows(plat, W)]
    planner = Planner(interop.port(plat), engine="numpy", device="cpu")
    tinst = interop.port(inst)
    with PlanningSession(planner, tinst, twin.__getitem__, n_windows=3,
                         lookahead=1) as sess:
        sess.plan_for(0)
        assert 1 in sess._plans and 2 not in sess._plans
        sess.plan_for(1)
        assert 2 in sess._plans
        with pytest.raises(IndexError):
            sess.plan_for(3)
    with pytest.raises(RuntimeError, match="closed"):
        sess.plan_for(0)
    with PlanningSession(planner, tinst, twin[:2]) as sess:
        assert sess.n_windows == 2
        assert [k for k, _ in sess.windows()] == [0, 1]
    with pytest.raises(ValueError, match="n_windows"):
        PlanningSession(planner, tinst, twin.__getitem__)
    with pytest.raises(ValueError, match="exceeds"):
        PlanningSession(planner, tinst, twin[:2], n_windows=3)


class _StallingPlanner:
    """Plans window 0 at once and stalls later windows until their
    CancelToken fires (then stops as a solver's checkpoint would)."""

    def __init__(self):
        self.started = threading.Event()

    def plan(self, request, cancel=None):
        if request.profiles == "w0":
            return "plan 0"
        self.started.set()
        while not cancel.cancelled:
            time.sleep(0.005)
        cancel.check()


def test_close_cancels_the_inflight_window():
    planner = _StallingPlanner()
    sess = PlanningSession(planner, instances=None,
                           window_profiles=["w0", "w1", "w2"], lookahead=2)
    assert sess.plan_for(0) == "plan 0"
    assert planner.started.wait(5.0)           # window 1 is in flight
    t0 = time.perf_counter()
    sess.close()
    assert time.perf_counter() - t0 < 5.0
    assert sess._tokens[1].cancelled
    assert sess._plans[2].cancelled()          # queued: never started
    with pytest.raises(Cancelled):
        sess._plans[1].result()
    with pytest.raises(RuntimeError, match="closed"):
        sess.plan_for(1)
