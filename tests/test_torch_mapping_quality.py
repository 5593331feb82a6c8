"""Port parity, the mapping axis: the search and HEFT mode on
``tests/test_mapping.py``'s search-quality case, against repro's, and the
plans' wire round trip.

Split from ``test_torch_mapping.py`` (whose helpers it uses), so that
under ``--dist loadfile`` these slow searches run on a worker of their
own. The module fixture ``quality_setup`` is built once for both tests.
Every comparison is bitwise, as in ``test_torch_mapping.py``.
"""
import json

import numpy as np
import pytest

from repro.core import (build_instance, deadline_from_asap, heft_mapping,
                        trivial_mapping)
from repro.workflows import make_workflow
from repro_torch import interop
from repro_torch.api import Planner, PlanRequest, PlanResult
from repro_torch.core import build_instance as t_build_instance
from repro_torch.core import schedule_cost as t_schedule_cost
from test_torch_mapping import (_assert_same_plan, _plan_both,
                                _scarce_profile, platform)  # noqa: F401


@pytest.fixture(scope="module")
def quality_setup(platform):
    """tests/test_mapping.py's TestSearchQuality case: a horizon roomy for
    HEFT (3x its ASAP) yet tight for the round-robin mapping."""
    wf = make_workflow("bacass", 2, seed=1)
    inst_h = build_instance(wf, heft_mapping(wf, platform), platform)
    fixed = build_instance(wf, trivial_mapping(wf, platform), platform)
    T = max(deadline_from_asap(inst_h, 3.0),
            int(deadline_from_asap(fixed, 1.0) * 1.1))
    return wf, _scarce_profile(platform, T), fixed


def test_search_and_heft_match_reference(platform, quality_setup):
    wf, prof, fixed = quality_setup
    opts = {"seeds": 6, "rounds": 3, "neighbors": 9, "seed": 0}
    want_s, got_s = _plan_both(platform, wf, prof, mapping="search",
                               mapping_options=opts)
    _assert_same_plan(want_s, got_s)
    want_h, got_h = _plan_both(platform, wf, prof, mapping="heft")
    _assert_same_plan(want_h, got_h)
    got_f = Planner(interop.port(platform), engine="torch",
                    device="cpu").plan(PlanRequest(
                        instances=interop.port(fixed),
                        profiles=interop.port(prof)))
    # the reference's quality chain holds on the port's plans
    assert got_s.best().cost <= got_h.best().cost <= got_f.best().cost
    info = got_s.mapping_info[0]
    assert info.mode == "search" and info.candidates >= 6
    assert info.trace == tuple(sorted(info.trace, reverse=True))
    assert got_s.best().cost == info.trace[-1] == min(info.candidate_costs)
    assert len(info.candidate_costs) == len(info.candidate_labels) \
        == info.candidates
    inst_w = t_build_instance(interop.port(wf), got_s.mappings[0],
                              interop.port(platform))
    best = got_s.best()
    assert t_schedule_cost(inst_w, interop.port(prof), best.start) \
        == best.cost
    assert np.array_equal(got_h.mappings[0].proc,
                          heft_mapping(wf, platform).proc)


def test_heft_mode_info_and_wire_round_trip(platform, quality_setup):
    wf, prof, _ = quality_setup
    planner = Planner(interop.port(platform), engine="torch", device="cpu")
    for mode, opts in (("heft", None),
                       ("search", {"seeds": 3, "rounds": 1,
                                   "neighbors": 3})):
        res = planner.plan(PlanRequest(instances=interop.port(wf),
                                       profiles=interop.port(prof),
                                       mapping=mode, mapping_options=opts))
        d = res.summary_dict()
        back = PlanResult.summary_from_dict(json.loads(json.dumps(d)))
        assert back.summary_dict() == d
        assert back.mapping_mode == mode
        assert back.mapping_info == res.mapping_info
        assert back.mapping_info[0].mode == mode
    fixed = planner.plan(PlanRequest(
        instances=t_build_instance(interop.port(wf), res.mappings[0],
                                   interop.port(platform)),
        profiles=interop.port(prof)))
    assert fixed.mapping_mode == "fixed"
    assert fixed.mappings is None and fixed.mapping_info is None
    # the winner re-planned under mapping="fixed" reproduces the search
    assert np.array_equal(fixed.costs, res.costs)
