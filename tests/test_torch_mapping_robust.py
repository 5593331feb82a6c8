"""Port parity, the mapping axis: a robust search over two profiles
against repro's, and its bit-reproducibility per seed.

Split from ``test_torch_mapping.py`` (whose helpers it uses), so that
under ``--dist loadfile`` this slow search runs on a worker of its own.
Every comparison is bitwise, as in ``test_torch_mapping.py``.
"""
from repro.workflows import make_workflow
from repro_torch import interop
from repro_torch.api import Planner, PlanRequest
from test_torch_mapping import (_assert_same_plan, _plan_both,
                                _port_profiles, _scarce_profile,
                                platform)  # noqa: F401


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
