"""Port parity, the legacy entry points the reference's tests and the
README's migration section still call: ``schedule``, ``schedule_reference``,
``schedule_portfolio(_multi)``, ``portfolio_starts_batch``,
``greedy_fanout_torch`` (repro's ``greedy_fanout_jax``) and
``local_search_batched``, each bitwise equal to the reference's on
``make_cluster(1) x make_workflow(kind, 3)`` for two kinds, on the CPU."""
import numpy as np
import pytest
import torch

import repro.core as r_core
from repro.cluster import make_cluster
from repro.core import (build_instance, deadline_from_asap,
                        generate_profile, heft_mapping)
from repro.core.greedy_jax import greedy_fanout_jax
from repro.core.local_search_jax import \
    local_search_batched as r_local_search_batched
from repro.core.portfolio import \
    portfolio_starts_batch as r_portfolio_starts_batch
from repro.workflows import make_workflow
import repro_torch.core as t_core
from repro_torch import interop
from repro_torch.core.greedy_torch import greedy_fanout_torch
from repro_torch.core.local_search_torch import local_search_batched
from repro_torch.core.portfolio import portfolio_starts_batch

KINDS = ("eager", "methylseq")


def _case(kind, seed=0, scenario="S3"):
    plat = make_cluster(1, seed=seed)
    wf = make_workflow(kind, 3, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    prof = generate_profile(scenario, deadline_from_asap(inst, 2.0), plat,
                            J=12, seed=seed + 1)
    return plat, inst, prof


def _ported(*objs):
    return [interop.port(o) for o in objs]


def _same_result(want, got):
    assert got.variant == want.variant
    assert got.cost == want.cost
    assert np.array_equal(np.asarray(got.start), np.asarray(want.start))


@pytest.mark.parametrize("variant", ["asap", "slackR", "pressWR-LS"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn", ["schedule", "schedule_reference"])
def test_schedule_matches_reference(fn, kind, variant):
    plat, inst, prof = _case(kind)
    want = getattr(r_core, fn)(inst, prof, plat, variant)
    kw = {"device": "cpu"} if fn == "schedule" else {}
    got = getattr(t_core, fn)(*_ported(inst, prof, plat), variant, **kw)
    _same_result(want, got)


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_portfolio_matches_reference(kind):
    plat, inst, prof = _case(kind)
    want = r_core.schedule_portfolio(inst, prof, plat)
    tinst, tprof, tplat = _ported(inst, prof, plat)
    prep = t_core.prepare_instance(tinst, tprof, tplat)
    got = t_core.schedule_portfolio(tinst, tprof, tplat, prep=prep,
                                    device="cpu")
    assert list(got) == list(want)
    for name in want:
        _same_result(want[name], got[name])


@pytest.mark.parametrize("engines", [("numpy", "numpy"), ("jax", "torch")])
def test_schedule_portfolio_multi_matches_reference(engines):
    plat, inst, prof = _case("methylseq")
    prof2 = generate_profile("S1", prof.T, plat, J=12, seed=9)
    want = r_core.schedule_portfolio_multi(inst, [prof, prof2], plat,
                                           engine=engines[0])
    tinst, tprof, tprof2, tplat = _ported(inst, prof, prof2, plat)
    got = t_core.schedule_portfolio_multi(tinst, [tprof, tprof2], tplat,
                                          engine=engines[1], device="cpu")
    assert len(got) == 2
    for w, g in zip(want, got):
        assert list(g) == list(w)
        for name in w:
            _same_result(w[name], g[name])
    assert t_core.schedule_portfolio_multi(tinst, [], tplat,
                                           device="cpu") == []


def test_portfolio_starts_batch_matches_reference():
    preps, tpreps = [], []
    for kind in KINDS:
        plat, inst, prof = _case(kind)
        preps.append(r_core.prepare_instance(inst, prof, plat))
        tpreps.append(t_core.prepare_instance(*_ported(inst, prof, plat)))
    want = r_portfolio_starts_batch(preps)
    got = portfolio_starts_batch(tpreps, device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == w.dtype == np.int64
        assert np.array_equal(w, g)


@pytest.mark.parametrize("kind", KINDS)
def test_greedy_fanout_matches_reference(kind):
    plat, inst, prof = _case(kind)
    prep = r_core.prepare_instance(inst, prof, plat)
    combos = [(s, w, r) for s in ("slack", "press") for w in (False, True)
              for r in (False, True)]
    masks = np.stack([prep.masks[r] for (_, _, r) in combos])
    orders = np.stack([prep.graph.order_for(s, w) for (s, w, _) in combos])
    want = np.asarray(greedy_fanout_jax(inst, prof, prep.est0, prep.lst0,
                                        masks, orders))
    tinst, tprof = _ported(inst, prof)
    got = greedy_fanout_torch(tinst, tprof, prep.est0, prep.lst0, masks,
                              orders, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_local_search_batched_matches_reference(kind):
    plat, inst, prof = _case(kind)
    start = r_core.schedule_reference(inst, prof, plat, "pressW").start
    want = r_local_search_batched(inst, prof, start, mu=6, max_rounds=40)
    tinst, tprof = _ported(inst, prof)
    got = local_search_batched(tinst, tprof, start, mu=6, max_rounds=40,
                               device="cpu")
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(want, got)
    assert not np.array_equal(got, start)   # the climb moved something
