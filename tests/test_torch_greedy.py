"""Port parity, greedy fan-out: repro_torch's batched torch greedy against
repro's lax.scan greedy (greedy_schedule_jax / greedy_fanout_multi_jax /
greedy_fanout_grid_jax), bitwise, on the CPU; and the longest-path
matrix and its blocked form against repro's."""
import numpy as np
import pytest

from repro.cluster import make_cluster
from repro.core import (build_instance, deadline_from_asap,
                        generate_profile, heft_mapping)
from repro.core import greedy_jax as rj
from repro.core.estlst import compute_est, compute_lst
from repro.core.portfolio import prepare_graph, schedule_portfolio_grid
from repro.core.scores import task_order
from repro.core.subdivide import candidate_mask
from repro.workflows import make_workflow
from repro_torch import interop
from repro_torch.core import greedy_torch as tgr
from repro_torch.core.portfolio import \
    prepare_graph as t_prepare_graph
from repro_torch.core.portfolio import \
    schedule_portfolio_grid as t_grid

COMBOS = [(s, w, r) for s in ("slack", "press") for w in (False, True)
          for r in (False, True)]


def _setup(kind, samples, seed, factor, scenario, J=12):
    plat = make_cluster(1, seed=seed)
    wf = make_workflow(kind, samples, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, factor)
    prof = generate_profile(scenario, T, plat, J=J, seed=seed)
    return plat, inst, prof


def _port(*objs):
    return [interop.port(o) for o in objs]


@pytest.mark.parametrize("seed,kind,scen,sc,wt,rf", [
    (3, "eager", "S3", "press", True, True),
    (1, "atacseq", "S1", "slack", False, False),
    (7, "bacass", "S4", "press", False, True),
    (2, "methylseq", "S2", "slack", True, False),
])
def test_greedy_schedule_matches_jax(seed, kind, scen, sc, wt, rf):
    """The four cases of tests/test_device_paths.py."""
    plat, inst, prof = _setup(kind, 3, seed, 1.5, scen)
    want = np.asarray(rj.greedy_schedule_jax(
        inst, prof, plat, score=sc, weighted=wt, refined=rf))
    got = tgr.greedy_schedule_torch(*_port(inst, prof, plat), score=sc,
                                    weighted=wt, refined=rf,
                                    device="cpu").numpy()
    assert got.dtype == np.int32 and np.array_equal(want, got)


@pytest.mark.parametrize("seed,kind", [(0, "eager"), (6, "bacass")])
def test_greedy_at_tight_deadline_matches_jax(seed, kind):
    """tests/test_portfolio.py:146: deadline = ASAP makespan."""
    plat, inst, prof = _setup(kind, 3, seed, 1.0, "S2", J=16)
    want = np.asarray(rj.greedy_schedule_jax(inst, prof, plat, "press",
                                             True, False))
    got = tgr.greedy_schedule_torch(*_port(inst, prof, plat), "press",
                                    True, False, device="cpu").numpy()
    assert np.array_equal(want, got)


def _multi_inputs(plat, inst, profs):
    T = profs[0].T
    est = compute_est(inst)
    lst = compute_lst(inst, T)
    orders = np.stack([task_order(inst, est, lst, s, w, plat)
                       for (s, w, _) in COMBOS])
    masks = np.stack([np.stack([candidate_mask(inst, p, refined=r)
                                for (_, _, r) in COMBOS]) for p in profs])
    budgets = np.stack([p.unit_budget(inst.idle_total) for p in profs])
    return T, budgets, masks, orders, est, lst


def test_overrunning_task_matches_jax():
    """tests/test_portfolio.py:114: a sink placed LAST with its window
    pinned to T-1 overruns the horizon; its end must not become a
    candidate point, on both engines."""
    plat, inst, prof = _setup("eager", 2, 2, 1.5, "S3", J=16)
    T, budgets, masks, orders, est, lst = _multi_inputs(plat, inst, [prof])
    sinks = np.flatnonzero(np.diff(inst.succ_ptr) == 0)
    v0 = int(sinks[np.argmax(inst.dur[sinks])])
    assert inst.dur[v0] >= 2
    orders = np.stack([np.concatenate([o[o != v0], [v0]]) for o in orders])
    est, lst = est.copy(), lst.copy()
    est[v0] = lst[v0] = T - 1
    want = np.asarray(rj.greedy_fanout_multi_jax(
        inst, T, budgets, masks, orders, est, lst))
    got = tgr.greedy_fanout_multi_torch(
        interop.port(inst), T, budgets, masks, orders, est, lst,
        device="cpu").numpy()
    assert np.array_equal(want, got)
    assert (got[0, :, v0] + inst.dur[v0] > T).all()   # it really clipped


@pytest.mark.parametrize("seed,kind", [(4, "atacseq"), (9, "methylseq")])
def test_multi_profile_fanout_matches_jax(seed, kind):
    plat, inst, _ = _setup(kind, 3, seed, 1.5, "S1")
    T = deadline_from_asap(inst, 1.5)
    profs = [generate_profile(s, T, plat, J=12, seed=seed + i)
             for i, s in enumerate(("S1", "S3", "S4"))]
    T, budgets, masks, orders, est, lst = _multi_inputs(plat, inst, profs)
    want = np.asarray(rj.greedy_fanout_multi_jax(
        inst, T, budgets, masks, orders, est, lst))
    got = tgr.greedy_fanout_multi_torch(
        interop.port(inst), T, budgets, masks, orders, est, lst,
        device="cpu").numpy()
    assert got.shape == (3, 8, inst.num_tasks)
    assert np.array_equal(want, got)


def test_grid_fanout_matches_jax():
    """Two instances of one shape bucket ride one grid launch (jax) / one
    batched loop (torch): every (instance, profile, variant) row equal."""
    plat = make_cluster(1, seed=5)
    insts = [build_instance(wf, heft_mapping(wf, plat), plat) for wf in
             (make_workflow("bacass", 3, seed=s) for s in (5, 8))]
    T = max(deadline_from_asap(i, 1.5) for i in insts)
    Np, Tp = rj.pad_dims(insts[0].num_tasks, T)
    assert rj.pad_dims(insts[1].num_tasks, T) == (Np, Tp)
    profs = [generate_profile(s, T, plat, J=12, seed=3)
             for s in ("S2", "S4")]
    rows_r, rows_t = [], []
    for inst in insts:
        _, budgets, masks, orders, est, lst = _multi_inputs(plat, inst,
                                                            profs)
        dur, work, lp, est_j, lst_j, tail = rj.padded_shared(inst, est, lst)
        tdur, twork, tlp, test, tlst, _ = tgr.padded_shared(
            interop.port(inst), est, lst, device="cpu")
        per_call = (rj.pad_budget(budgets, Tp), rj.pad_masks(masks, Tp),
                    rj.pad_orders(orders, tail))
        rows_r.append((dur, work, lp, per_call[0], per_call[1], est_j,
                       lst_j, per_call[2]))
        rows_t.append((tdur, twork, tlp, per_call[0], per_call[1], test,
                       tlst, per_call[2]))
    want = np.asarray(rj.greedy_fanout_grid_jax(rows_r))
    got = tgr.greedy_fanout_grid_torch(rows_t, device="cpu").numpy()
    assert got.shape == want.shape == (2, 2, 8, Np)
    assert np.array_equal(want, got)


def _force_blocked_budget(inst, T):
    Np, _ = rj.pad_dims(inst.num_tasks, T)
    budget = rj.lp_block_bytes(2, len(COMBOS), Np)
    if budget >= rj.lp_matrix_bytes(inst.num_tasks):
        budget = rj.lp_block_bytes(1, len(COMBOS), Np)
    assert budget < rj.lp_matrix_bytes(inst.num_tasks)
    return budget


def test_mixed_dense_blocked_bucket_matches_jax():
    """tests/test_lp_blocked.py:166: one bucket mixing a dense-lp and a
    blocked-lp instance; the torch grid equals the jax grid, and the
    blocked row equals the all-dense run."""
    insts = []
    for seed in (2, 6):                  # test_lp_blocked's _instance()
        plat = make_cluster(1, seed=seed)
        wf = make_workflow("bacass", 4, seed=seed)
        insts.append(build_instance(wf, heft_mapping(wf, plat), plat))
    plat = make_cluster(1, seed=2)
    T = max(deadline_from_asap(i, 1.5) for i in insts)
    assert len({rj.pad_dims(i.num_tasks, T) for i in insts}) == 1
    profs = [[generate_profile("S1", T, plat, J=16, seed=1)]] * 2
    budget = _force_blocked_budget(insts[1], T)
    graphs_r = [None, prepare_graph(insts[1], plat, T,
                                    lp_budget_bytes=budget)]
    want = schedule_portfolio_grid(insts, profs, plat, engine="jax",
                                   graphs=graphs_r)
    tinsts = _port(*insts)
    tplat = interop.port(plat)
    tprofs = [[interop.port(profs[0][0])]] * 2
    graphs_t = [None, t_prepare_graph(tinsts[1], tplat, T,
                                      lp_budget_bytes=budget)]
    assert graphs_t[1].lp_is_blocked
    got = t_grid(tinsts, tprofs, tplat, engine="torch", graphs=graphs_t,
                 device="cpu")
    dense = t_grid(tinsts, tprofs, tplat, engine="torch", device="cpu")
    for i in range(2):
        for name, ref in want[i][0].items():
            assert np.array_equal(got[i][0][name].start, ref.start), \
                (i, name)
            assert np.array_equal(dense[i][0][name].start, ref.start), \
                (i, name)


@pytest.mark.parametrize("kind,seed", [("eager", 0), ("atacseq", 3)])
def test_longest_paths_match_reference(kind, seed):
    plat = make_cluster(1, seed=seed)
    wf = make_workflow(kind, 3, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    tinst = interop.port(inst)
    lp = rj.longest_path_matrix(inst)
    assert np.array_equal(lp, tgr.longest_path_matrix(tinst))
    blp = tgr.BlockedLP(tinst)
    for block in (1, 7, inst.num_tasks):
        assert np.array_equal(blp.materialize(block), lp)
    Np, _ = tgr.pad_dims(inst.num_tasks, 1)
    vs = np.array([[0, 5, Np - 1], [3, inst.num_tasks - 1, 2]])
    for a, b in zip(rj.BlockedLP(inst).chunk_tensors(vs, Np),
                    blp.chunk_tensors(vs, Np)):
        assert np.array_equal(a, b)
    assert blp.chunk_width(8, Np) == rj.BlockedLP(inst).chunk_width(8, Np)
    with pytest.raises(MemoryError, match="BlockedLP"):
        tgr.longest_path_matrix(tinst, max_bytes=8)
