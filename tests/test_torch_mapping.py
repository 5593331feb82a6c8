"""Port parity, the mapping axis: repro_torch's joint mapping search,
HEFT mode, seeds, moves, options and ``dot_io`` against repro's.

Searches run through repro's ``Planner(engine="jax")`` (on the CPU) and
repro_torch's ``Planner(engine="torch", device="cpu")`` from the same
seeds, on the cases of ``tests/test_mapping.py`` that need no
``PlanService``. Every comparison is bitwise (tolerance 0): the winner's
label and ``proc`` vector, ``candidate_labels``, ``candidate_costs``,
``trace``, ``rounds``, ``candidates``, ``infeasible``, the int64 cost
tensor and every schedule's start vector. ``cache_misses`` is left out of
the parity: jax counts compiled signatures and the port counts padded
``(Npad, Tp)`` buckets; the port's own steady-state and pad-row properties
are tested on their own below.
"""
import json

import numpy as np
import pytest
import torch

from repro.api import Planner as RPlanner
from repro.api import PlanRequest as RRequest
from repro.cluster import make_cluster
from repro.core import (build_instance, deadline_from_asap, generate_profile,
                        heft_mapping, trivial_mapping)
from repro.mapping import MappingOptions as RMappingOptions
from repro.mapping import critical_path as r_critical_path
from repro.mapping import heft_generic as r_heft_generic
from repro.mapping import mapping_from_assignment as r_from_assignment
from repro.mapping import neighborhood as r_neighborhood
from repro.mapping import rank_priority as r_rank_priority
from repro.mapping import seed_mappings as r_seed_mappings
from repro.mapping import upward_ranks as r_upward_ranks
from repro.workflows import Workflow, make_workflow
from repro.workflows import dot_io as r_dot_io
from repro_torch import interop, obs
from repro_torch.api import MAPPING_MODES, Planner, PlanRequest, PlanResult
from repro_torch.core import build_instance as t_build_instance
from repro_torch.core import schedule_cost as t_schedule_cost
from repro_torch.core.cancel import Cancelled, CancelToken
from repro_torch.core.estlst import makespan as t_makespan
from repro_torch.mapping import (MappingOptions, critical_path, heft_generic,
                                 mapping_from_assignment, neighborhood,
                                 rank_priority, seed_mappings, upward_ranks)
from repro_torch.workflows import dot_io


@pytest.fixture(scope="module")
def platform():
    return make_cluster(1, seed=0)       # 6 compute procs, one per type


def _scarce_profile(platform, T, seed=2, cap=40):
    return generate_profile("S3", T, platform, J=12, seed=seed,
                            work_capacity=cap)


def _port_profiles(profiles):
    if not isinstance(profiles, (list, tuple)):
        return interop.port(profiles)
    return [interop.port(p) for p in profiles]


def _plan_both(platform, wf, profiles, **kw):
    """The same mapping-mode request through repro (jax engine) and
    repro_torch (torch engine on the CPU)."""
    want = RPlanner(platform, engine="jax").plan(
        RRequest(instances=wf, profiles=profiles, **kw))
    got = Planner(interop.port(platform), engine="torch",
                  device="cpu").plan(
        PlanRequest(instances=interop.port(wf),
                    profiles=_port_profiles(profiles), **kw))
    return want, got


_INFO_FIELDS = ("mode", "objective", "label", "rounds", "candidates",
                "infeasible", "trace", "candidate_labels", "candidate_costs")


def _assert_same_plan(want, got):
    assert got.mapping_mode == want.mapping_mode
    assert got.costs.dtype == np.int64
    assert np.array_equal(want.costs, got.costs)
    assert got.variants == want.variants
    I, P, _ = want.costs.shape
    for i in range(I):
        wm, gm = want.mappings[i], got.mappings[i]
        assert np.array_equal(wm.proc, gm.proc)
        assert wm.order == gm.order and wm.comm_order == gm.comm_order
        wi, gi = want.mapping_info[i], got.mapping_info[i]
        for f in _INFO_FIELDS:
            assert getattr(wi, f) == getattr(gi, f), f
        for p in range(P):
            for n in want.variants:
                assert np.array_equal(want.results[i][p][n].start,
                                      got.results[i][p][n].start), (i, p, n)


# ---------------------------------------------------------------------------
# HEFT, seeds and moves: the framework-free copies against repro's
# ---------------------------------------------------------------------------

def test_upward_ranks_and_heft_generic_match_reference(platform):
    wf = make_workflow("atacseq", 2, seed=3)
    tplat, twf = interop.port(platform), interop.port(wf)
    mean = np.maximum(np.ceil(wf.node_w[:, None] / platform.speed[None, :]),
                      1).mean(axis=1)
    assert np.array_equal(r_upward_ranks(wf, mean), upward_ranks(twf, mean))
    slow = platform.speed <= np.median(platform.speed)
    for kw in ({}, {"allowed": slow}):
        want = r_heft_generic(wf, platform, **kw)
        got = heft_generic(twf, tplat, **kw)
        assert np.array_equal(want.proc, got.proc)
        assert want.order == got.order
        assert want.comm_order == got.comm_order
    assert np.array_equal(heft_generic(twf, tplat).proc,
                          heft_mapping(wf, platform).proc)


def test_seed_mappings_match_reference(platform):
    wf = make_workflow("eager", 2, seed=0)
    prof = _scarce_profile(platform, 300)
    opts = {"seeds": 6, "seed": 3}
    want = r_seed_mappings(wf, platform, [prof], RMappingOptions(**opts))
    got = seed_mappings(interop.port(wf), interop.port(platform),
                        [interop.port(prof)], MappingOptions(**opts))
    assert [lab for lab, _ in want] == [lab for lab, _ in got]
    for (_, wm), (_, gm) in zip(want, got):
        assert np.array_equal(wm.proc, gm.proc)
        assert wm.order == gm.order and wm.comm_order == gm.comm_order


def test_moves_match_reference(platform):
    wf = make_workflow("methylseq", 2, seed=7)
    tplat, twf = interop.port(platform), interop.port(wf)
    prio = r_rank_priority(wf, platform)
    assert np.array_equal(prio, rank_priority(twf, tplat))
    rng = np.random.default_rng(0)
    for _ in range(10):
        proc = rng.integers(platform.num_compute, size=wf.n)
        want = r_from_assignment(wf, platform, proc, prio)
        got = mapping_from_assignment(twf, tplat, proc, prio)
        assert np.array_equal(want.proc, got.proc)
        assert want.order == got.order and want.comm_order == got.comm_order
        t_build_instance(twf, got, tplat)      # asserts G_c acyclic
        assert list(r_critical_path(wf, platform, proc)) == \
            list(critical_path(twf, tplat, proc))
    base = heft_mapping(wf, platform).proc
    want = r_neighborhood(wf, platform, [base], np.random.default_rng(9), 9)
    got = neighborhood(twf, tplat, [base], np.random.default_rng(9), 9)
    assert len(got) == 9
    assert {k for k, _ in got} == {"reassign", "swap", "migrate"}
    for (kw, vw), (kg, vg) in zip(want, got):
        assert kw == kg and np.array_equal(vw, vg)


# ---------------------------------------------------------------------------
# MappingOptions: validation and budget-aware shrinking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    {"nope": 1},                      # unknown key
    {"seeds": 0},                     # below bound
    {"rounds": -1},
    {"objective": "fastest"},         # unknown objective
    {"seeds": "many"},                # wrong type
    "not-a-dict",
])
def test_malformed_mapping_options_rejected(platform, bad):
    wf = interop.port(make_workflow("eager", 2, seed=0))
    prof = interop.port(_scarce_profile(platform, 300))
    with pytest.raises(ValueError, match="mapping_options"):
        PlanRequest(instances=wf, profiles=prof, mapping="search",
                    mapping_options=bad).resolve()
    with pytest.raises(ValueError, match="mapping_options"):
        RRequest(instances=make_workflow("eager", 2, seed=0),
                 profiles=_scarce_profile(platform, 300), mapping="search",
                 mapping_options=bad).resolve()


def test_mapping_options_round_trip_and_shrunk_to_match_reference():
    opts = dict(seeds=6, rounds=4, neighbors=12, elite=3, seed=9,
                objective="robust")
    mine, ref = MappingOptions(**opts), RMappingOptions(**opts)
    assert mine.to_dict() == ref.to_dict()
    assert MappingOptions.from_dict(mine.to_dict()) == mine
    assert MappingOptions.from_dict(None) == MappingOptions()
    assert MappingOptions.from_dict(mine) is mine
    assert mine.max_candidates() == ref.max_candidates() == 54
    assert mine.shrunk_to(54) is mine and mine.shrunk_to(999) is mine
    for budget in range(-3, mine.max_candidates() + 1):
        s, r = mine.shrunk_to(budget), ref.shrunk_to(budget)
        assert (s is None) == (r is None), budget
        if s is not None:
            assert s.to_dict() == r.to_dict(), budget
            assert s.max_candidates() <= budget
            assert s.seed == 9 and s.objective == "robust"
    tight = MappingOptions(seeds=4, rounds=4, neighbors=10).shrunk_to(7)
    assert (tight.seeds, tight.neighbors, tight.rounds) == (4, 3, 1)


# ---------------------------------------------------------------------------
# request validation on the mapping axis
# ---------------------------------------------------------------------------

def test_request_validation_on_the_mapping_axis(platform, medium_instance):
    assert MAPPING_MODES == ("fixed", "heft", "search")
    wf = interop.port(make_workflow("eager", 2, seed=0))
    prof = interop.port(_scarce_profile(platform, 300))
    inst = interop.port(medium_instance)
    with pytest.raises(ValueError, match="unknown mapping"):
        PlanRequest(instances=wf, profiles=prof, mapping="bogus").resolve()
    with pytest.raises(ValueError, match="mapping_options"):
        PlanRequest(instances=inst, profiles=prof,
                    mapping_options={"seeds": 3}).resolve()
    with pytest.raises(TypeError, match="Workflow"):
        PlanRequest(instances=inst, profiles=prof, mapping="heft").resolve()
    with pytest.raises(TypeError, match="Workflow"):
        PlanRequest(instances=[wf, inst], profiles=prof,
                    mapping="search").resolve()
    for mode in ("heft", "search"):        # the crop is deferred
        insts, grid, _ = PlanRequest(
            instances=wf, profiles=prof, mapping=mode,
            deadline_scale=1.5).resolve()
        assert insts == [wf]
        assert grid[0][0].T == prof.T


# ---------------------------------------------------------------------------
# the search, HEFT mode and deadline_scale against repro
# ---------------------------------------------------------------------------

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


def test_search_over_two_profiles_robust_matches_reference(platform):
    wf = make_workflow("eager", 2, seed=0)
    profs = [_scarce_profile(platform, 300, seed=s) for s in (2, 5)]
    want, got = _plan_both(platform, wf, profs, mapping="search",
                           robust=True,
                           mapping_options={"seeds": 4, "rounds": 2,
                                            "neighbors": 6, "seed": 42})
    assert got.mapping_info[0].objective == "robust"
    _assert_same_plan(want, got)
    again = Planner(interop.port(platform), engine="torch",
                    device="cpu").plan(PlanRequest(
                        instances=interop.port(wf),
                        profiles=_port_profiles(profs), mapping="search",
                        robust=True,
                        mapping_options={"seeds": 4, "rounds": 2,
                                         "neighbors": 6, "seed": 42}))
    _assert_same_plan(got, again)          # bit-reproducible per seed


@pytest.mark.parametrize("mode", ["heft", "search"])
def test_deadline_scale_crops_via_reference_heft(platform, mode):
    wf = make_workflow("eager", 2, seed=0)
    prof = _scarce_profile(platform, 600)
    ref = build_instance(wf, heft_mapping(wf, platform), platform)
    want_T = deadline_from_asap(ref, 2.0)
    assert want_T < prof.T                  # the crop is real
    want, got = _plan_both(
        platform, wf, prof, mapping=mode, deadline_scale=2.0,
        mapping_options=None if mode == "heft" else
        {"seeds": 3, "rounds": 1, "neighbors": 4})
    _assert_same_plan(want, got)
    assert got.mapping_info[0].mode == mode
    inst = t_build_instance(interop.port(wf), got.mappings[0],
                            interop.port(platform))
    for r in got.results[0][0].values():
        assert t_makespan(inst, r.start) <= want_T


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


def test_cancel_token_stops_search(platform):
    token = CancelToken()
    token.cancel("test")
    with pytest.raises(Cancelled):
        Planner(interop.port(platform), engine="torch", device="cpu").plan(
            PlanRequest(instances=interop.port(make_workflow("eager", 2,
                                                             seed=0)),
                        profiles=interop.port(_scarce_profile(platform, 400)),
                        mapping="search"), cancel=token)
    assert token.checks >= 1


# ---------------------------------------------------------------------------
# the port's own bucket properties (cache_misses and pad rows)
# ---------------------------------------------------------------------------

def test_candidate_batches_add_no_bucket_misses(platform):
    """Steady state, growing the candidate count adds no new (Npad, Tp)
    bucket: every later batch's ``cache_misses`` entry is 0."""
    wf = make_workflow("bacass", 2, seed=1)
    inst_h = build_instance(wf, heft_mapping(wf, platform), platform)
    T = min(deadline_from_asap(inst_h, 3.0), 250)   # stay in one T bucket
    prof = interop.port(_scarce_profile(platform, T))
    planner = Planner(interop.port(platform), engine="torch", device="cpu")
    planner.plan(PlanRequest(
        instances=interop.port(wf), profiles=[prof, prof], mapping="search",
        mapping_options={"seeds": 3, "rounds": 1, "neighbors": 3}))
    res = planner.plan(PlanRequest(
        instances=interop.port(wf), profiles=[prof, prof], mapping="search",
        mapping_options={"seeds": 6, "rounds": 2, "neighbors": 8,
                         "seed": 1}))
    info = res.mapping_info[0]
    assert info.candidates > 8
    assert len(info.cache_misses) == 1 + info.rounds
    assert sum(info.cache_misses) == 0, info.cache_misses


def test_padded_candidate_batch_counts_real_candidates_only(platform):
    """Each candidate batch is padded to the 8-wide bucket by repeating the
    last candidate by identity: the dedupe counter moves by the pad rows,
    and ``candidates``/``candidate_costs`` count only real candidates."""
    wf = make_workflow("eager", 2, seed=2)
    inst_h = build_instance(wf, heft_mapping(wf, platform), platform)
    prof = _scarce_profile(platform, deadline_from_asap(inst_h, 3.0))
    prev = obs.set_registry(obs.MetricsRegistry())
    try:
        res = Planner(interop.port(platform), engine="torch",
                      device="cpu").plan(PlanRequest(
                          instances=interop.port(wf),
                          profiles=interop.port(prof), mapping="search",
                          mapping_options={"seeds": 3, "rounds": 0}))
        deduped = obs.registry().value("portfolio_rows_deduped_total")
    finally:
        obs.set_registry(prev)
    info = res.mapping_info[0]
    assert 1 <= info.candidates <= 3
    assert len(info.candidate_costs) == len(info.candidate_labels) \
        == info.candidates
    assert deduped == 8 - info.candidates


# ---------------------------------------------------------------------------
# workflows/dot_io
# ---------------------------------------------------------------------------

def test_dot_io_round_trip_matches_reference(tmp_path):
    wf = make_workflow("methylseq", 2, seed=4)
    r_path, t_path = tmp_path / "ref.dot", tmp_path / "port.dot"
    r_dot_io.save_dot(wf, str(r_path))
    dot_io.save_dot(interop.port(wf), str(t_path))
    assert t_path.read_text() == r_path.read_text()
    want = r_dot_io.load_dot(str(r_path))
    got = dot_io.load_dot(str(t_path))
    for f in ("node_w", "edges", "edge_w"):
        assert np.array_equal(getattr(want, f), getattr(got, f)), f
        assert np.array_equal(getattr(wf, f), getattr(got, f)), f
    # Nextflow pseudo-tasks are dropped and their edges reconnected
    text = ('digraph "p" {\n  a [weight=3];\n  b [weight=4];\n'
            '  c [weight=5];\n  a -> b;\n  b -> c;\n}\n')
    src = tmp_path / "pseudo.dot"
    src.write_text(text)
    want = r_dot_io.load_dot(str(src), pseudo_patterns=("b",), seed=1)
    got = dot_io.load_dot(str(src), pseudo_patterns=("b",), seed=1)
    assert isinstance(want, Workflow) and got.n == want.n == 2
    for f in ("node_w", "edges", "edge_w"):
        assert np.array_equal(getattr(want, f), getattr(got, f)), f


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_search_matches_cpu(platform):
    """The search on the card (gain sweeps through the CUDA kernel) gives
    the CPU's result bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    wf = interop.port(make_workflow("eager", 2, seed=0))
    prof = interop.port(_scarce_profile(platform, 300))
    req = PlanRequest(instances=wf, profiles=[prof, prof], mapping="search",
                      mapping_options={"seeds": 4, "rounds": 2,
                                       "neighbors": 6})
    tplat = interop.port(platform)
    card = Planner(tplat, engine="torch").plan(req)
    cpu = Planner(tplat, engine="torch", device="cpu").plan(req)
    _assert_same_plan(cpu, card)
