"""The port's own bucket property of the mapping search: growing the
candidate count adds no new ``(Npad, Tp)`` bucket.

Split from ``test_torch_mapping.py`` (whose helpers it uses), so that
under ``--dist loadfile`` its two CPU searches run on a worker of their
own.
"""
from repro.core import build_instance, deadline_from_asap, heft_mapping
from repro.workflows import make_workflow
from repro_torch import interop
from repro_torch.api import Planner, PlanRequest
from test_torch_mapping import _scarce_profile, platform  # noqa: F401


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
