"""Port parity, device climb: repro_torch's row-batched torch climb against
repro's vmapped lax.while_loop climb (_climb_impl), bitwise in the climbed
starts AND the per-row round counts; local_search_portfolio_multi with and
without the polish; the climb's termination properties."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import make_cluster
from repro.core import (build_instance, deadline_from_asap,
                        generate_profile, heft_mapping)
from repro.core import local_search_jax as rl
from repro.core.carbon import work_timeline
from repro.core.greedy_jax import _bucket_up, greedy_fanout_multi_jax
from repro.core.portfolio import overlay_profile, prepare_graph
from repro.workflows import make_workflow
from repro_torch import interop
from repro_torch.core import local_search_torch as tl

LS_COMBOS = [(s, w, r) for s in ("slack", "press") for w in (False, True)
             for r in (False, True)]


def _rows(kind="eager", seed=4, samples=3, factor=2.0,
          scenarios=("S1", "S3")):
    """Greedy schedules of one instance for every (profile, combo) row,
    the climb's input as the portfolio engine builds it."""
    plat = make_cluster(1, seed=seed)
    wf = make_workflow(kind, samples, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, factor)
    profs = [generate_profile(s, T, plat, J=16, seed=seed + i)
             for i, s in enumerate(scenarios)]
    g = prepare_graph(inst, plat, T)
    ovs = [overlay_profile(g, p) for p in profs]
    orders = np.stack([g.order_for(s, w) for (s, w, _) in LS_COMBOS])
    masks = np.stack([np.stack([ov.masks[r] for (_, _, r) in LS_COMBOS])
                      for ov in ovs])
    budgets = np.stack([ov.unit_budget for ov in ovs])
    starts = np.asarray(greedy_fanout_multi_jax(
        inst, T, budgets, masks, orders, g.est0, g.lst0),
        dtype=np.int64).reshape(-1, inst.num_tasks)
    row_budgets = np.repeat(budgets, len(LS_COMBOS), axis=0)
    n_cand = max(len(ov.segs[r][0]) for ov in ovs for r in (False, True))
    return inst, T, row_budgets, starts, n_cand


def _padded(inst, T, budgets, starts):
    """local_search_portfolio_multi's bucket-padded climb inputs."""
    R, N = starts.shape
    Np, Tp, Rp = _bucket_up(N, 128), _bucket_up(T, 256), _bucket_up(R, 8)
    rem = np.zeros((Rp, Tp), np.int32)
    rem[:R, :T] = budgets - np.stack([work_timeline(inst, T, s)
                                      for s in starts])
    rem[R:] = rem[0]
    st = np.zeros((Rp, Np), np.int32)
    st[:R, :N] = starts
    st[R:] = st[0]
    dur = np.zeros(Np, np.int32)
    dur[:N] = inst.dur
    work = np.zeros(Np, np.int32)
    work[:N] = inst.task_work
    return rem, st, dur, work, Np


def _ref_adjacency(inst, Np, padded):
    N = inst.num_tasks
    if padded:
        out = []
        for a in rl._padded_adjacency(inst, None):
            p = np.zeros((Np, a.shape[1]), a.dtype)
            p[:N] = a
            out.append(jnp.asarray(p))
        return ((out[0], out[1]), (out[2], out[3]))
    out = []
    for a in rl._dense_adjacency(inst, None):
        p = np.zeros((Np, Np), bool)
        p[:N, :N] = a
        out.append(jnp.asarray(p))
    return tuple(out)


@pytest.mark.parametrize("commit_k", [1, 32, "auto"])
@pytest.mark.parametrize("adjacency", ["dense", "padded"])
def test_climb_starts_and_rounds_match_jax(adjacency, commit_k):
    inst, T, budgets, starts, n_cand = _rows()
    ck = rl.auto_commit_k(n_cand) if commit_k == "auto" else commit_k
    assert tl.auto_commit_k(n_cand) == rl.auto_commit_k(n_cand)
    rem, st, dur, work, Np = _padded(inst, T, budgets, starts)
    padded = adjacency == "padded"
    want_s, want_r = rl._climb_impl(10, 200, ck, padded)(
        jnp.asarray(rem), jnp.asarray(st), jnp.int32(T), jnp.asarray(dur),
        jnp.asarray(work), *_ref_adjacency(inst, Np, padded))
    tinst = interop.port(inst)
    adj = tl._device_adjacency(tinst, {}, Np, padded, torch.device("cpu"))
    got_s, got_r = tl.climb(
        torch.from_numpy(rem.copy()), torch.from_numpy(st.copy()), T,
        torch.from_numpy(dur), torch.from_numpy(work), adj, mu=10,
        max_rounds=200, commit_k=ck)
    assert np.array_equal(np.asarray(want_s), got_s.numpy())
    assert np.array_equal(np.asarray(want_r), got_r.numpy())
    assert (got_r.numpy() >= 1).all()
    assert not np.array_equal(got_s.numpy(), st)    # the climb moved tasks


@pytest.mark.parametrize("mu,max_rounds", [(4, 1), (7, 2)])
def test_climb_round_budget_freezes_rows_like_jax(mu, max_rounds):
    """Rows that hit max_rounds stop while the others continue; a small
    budget exercises the per-row freeze of the batched while_loop."""
    inst, T, budgets, starts, _ = _rows("atacseq", seed=1)
    rem, st, dur, work, Np = _padded(inst, T, budgets, starts)
    want_s, want_r = rl._climb_impl(mu, max_rounds, 32, False)(
        jnp.asarray(rem), jnp.asarray(st), jnp.int32(T), jnp.asarray(dur),
        jnp.asarray(work), *_ref_adjacency(inst, Np, False))
    adj = tl._device_adjacency(interop.port(inst), {}, Np, False,
                               torch.device("cpu"))
    got_s, got_r = tl.climb(
        torch.from_numpy(rem.copy()), torch.from_numpy(st.copy()), T,
        torch.from_numpy(dur), torch.from_numpy(work), adj, mu=mu,
        max_rounds=max_rounds, commit_k=32)
    assert np.array_equal(np.asarray(want_s), got_s.numpy())
    assert np.array_equal(np.asarray(want_r), got_r.numpy())
    assert got_r.max() == max_rounds


@pytest.mark.parametrize("polish", [False, True])
@pytest.mark.parametrize("adjacency", ["dense", "padded"])
def test_portfolio_multi_matches_jax(adjacency, polish):
    inst, T, budgets, starts, _ = _rows("bacass", seed=7)
    want = rl.local_search_portfolio_multi(
        inst, T, budgets, starts, polish=polish, adjacency=adjacency)
    got = tl.local_search_portfolio_multi(
        interop.port(inst), T, budgets, starts, polish=polish,
        adjacency=adjacency, device="cpu")
    assert got.dtype == np.int64 and np.array_equal(want, got)


def test_portfolio_single_profile_matches_jax():
    plat = make_cluster(1, seed=3)
    wf = make_workflow("methylseq", 3, seed=3)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, 1.5)
    prof = generate_profile("S4", T, plat, J=16, seed=3)
    _, _, _, starts, _ = _rows("methylseq", seed=3, factor=1.5,
                               scenarios=("S4",))
    want = rl.local_search_portfolio(inst, prof, starts, commit_k=8)
    got = tl.local_search_portfolio(interop.port(inst),
                                    interop.port(prof), starts, commit_k=8,
                                    device="cpu")
    assert np.array_equal(want, got)


def test_ls_rows_monotone_and_not_earlier_than_sequential():
    """tests/test_multiprofile.py:170,186 on the port: every -LS row costs
    no more than its greedy, and one more sequential-reference round is a
    no-op on it."""
    from repro_torch.api import Planner, PlanRequest
    from repro_torch.cluster import make_cluster as t_cluster
    from repro_torch.core import (build_instance as t_build,
                                  deadline_from_asap as t_deadline,
                                  generate_profile as t_profile,
                                  heft_mapping as t_heft,
                                  validate_schedule)
    from repro_torch.core.local_search import local_search
    from repro_torch.workflows import make_workflow as t_workflow

    plat = t_cluster(1, seed=4)
    wf = t_workflow("eager", 3, seed=4)
    inst = t_build(wf, t_heft(wf, plat), plat)
    T = t_deadline(inst, 2.0)
    prof = t_profile("S1", T, plat, J=16, seed=4)
    res = Planner(plat, engine="torch", device="cpu").plan(
        PlanRequest(instances=inst, profiles=[prof, prof]))
    for name in res.variants:
        if not name.endswith("-LS"):
            continue
        cell = res.results[0][0]
        validate_schedule(inst, prof, cell[name].start)
        assert cell[name].cost <= cell[name[:-3]].cost, name
        again = local_search(inst, prof, plat, cell[name].start,
                             max_rounds=1)
        assert np.array_equal(again, cell[name].start), name
