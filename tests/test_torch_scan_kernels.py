"""Port parity, the planner's two device loops: the greedy placement scan
(``repro_torch.kernels.greedy_scan``) and the climb's top-K commit scan
(``repro_torch.kernels.commit_scan``).

On the CPU the wrappers' plain versions are held bitwise to the reference's
``lax.scan`` greedy (``greedy_fanout_grid_jax``, dense and blocked) and to
its ``lax.while_loop`` climb (``_climb_impl``, dense and padded adjacency),
on seeded instances and on crafted edge cases: a flat budget (ties), a step
with no feasible unit, a task past the padded horizon, padded tasks; a
commit width below a row's positive proposals, moves whose window is
inverted (dlo > dhi), a row that stops climbing while the others go on, and
rows that hit ``max_rounds``. On the card (``-m cuda``) each kernel is held
bitwise to its plain version at the matrix's bucket (R=32, Np=4352,
Tp=1024), on the edge cases, with its state in device memory where it does
not fit shared memory, and the blocked greedy against the dense one; and on
the edges of the kernels' shared-memory rings: rows shorter than a stage or
carried in chunks, launches shorter than the ring, ragged rows the bulk
copies refuse, rows with fewer proposals than the ring is deep.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.core import greedy_torch as tgr
from repro_torch.core import local_search_torch as tl
from repro_torch.kernels import commit_scan as tcs
from repro_torch.kernels import greedy_scan as tgs

try:
    import jax.numpy as jnp

    from repro.cluster import make_cluster
    from repro.core import (build_instance, deadline_from_asap,
                            generate_profile, heft_mapping)
    from repro.core import greedy_jax as rj
    from repro.core import local_search_jax as rl
    from repro.workflows import make_workflow
    from repro_torch import interop
    from test_torch_climb import _padded, _ref_adjacency, _rows
    from test_torch_greedy import COMBOS, _multi_inputs
except ImportError:
    # the GPU host has no JAX; there `-m cuda` selects only the card tests
    # below, which need neither jax nor repro
    jnp = None



def _load_smoke():
    """``chip_smoke.py``, whose [kernels] helpers build the card cases and
    the climb's round inputs."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_smoke()

NP, TP = 128, 256          # the CPU cases' common shape bucket
CHUNK = 32                 # the blocked form's chunk width at that bucket

# (kind, seed, scenarios, crafted edge)
GREEDY_CASES = [("eager", 3, ("S1", "S3"), "seeded"),
                ("bacass", 7, ("S2", "S4"), "flat_budget"),
                ("atacseq", 1, ("S3", "S1"), "no_feasible_unit"),
                ("methylseq", 2, ("S4", "S2"), "overrun")]


def _greedy_row(kind, seed, scenarios, edge):
    """One instance's bucket row ``(dur, work, lp, budgets, masks, est,
    lst, orders)`` at (NP, TP) as numpy, crafted by ``edge``; with the
    instance and the crafted task (or None)."""
    plat = make_cluster(1, seed=seed)
    wf = make_workflow(kind, 3, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, 1.5)
    profs = [generate_profile(s, T, plat, J=12, seed=seed + i)
             for i, s in enumerate(scenarios)]
    T, budgets, masks, orders, est, lst = _multi_inputs(plat, inst, profs)
    N = inst.num_tasks
    est, lst = est.astype(np.int32), lst.astype(np.int32)
    v0 = None
    if edge == "flat_budget":
        budgets[0] = 7                 # every feasible unit ties
    elif edge == "no_feasible_unit":
        masks[0] = False               # first steps of profile 0: s = est
    elif edge == "overrun":
        sinks = np.flatnonzero(np.diff(inst.succ_ptr) == 0)
        v0 = int(sinks[np.argmax(inst.dur[sinks])])
        assert inst.dur[v0] >= 2
        orders = np.stack([np.concatenate([o[o != v0], [v0]])
                           for o in orders])
        est[v0] = lst[v0] = TP - 1     # ends past the padded horizon
    lp = np.full((NP, NP), tgr.NEG_PATH, dtype=np.int32)
    lp[:N, :N] = rj.longest_path_matrix(inst)
    np.fill_diagonal(lp[N:, N:], 0)

    def vec(x):
        out = np.zeros(NP, dtype=np.int32)
        out[:N] = x
        return out

    row = (vec(inst.dur), vec(inst.task_work), lp,
           rj.pad_budget(budgets, TP), rj.pad_masks(masks, TP),
           vec(est), vec(lst),
           rj.pad_orders(orders, np.arange(N, NP, dtype=np.int32)))
    return inst, row, v0


@pytest.fixture(scope="module")
def greedy_grid():
    """The four cases in one bucket: the reference's dense grid, its
    blocked runs of the first two, and the port's plain scans of both."""
    made = [_greedy_row(*c) for c in GREEDY_CASES]
    rows = [r for _, r, _ in made]
    want = np.asarray(rj.greedy_fanout_grid_jax(rows))
    budget = rj.lp_block_bytes(CHUNK, len(COMBOS), NP)
    blocked_rows = [r[:2] + (rj.BlockedLP(inst, budget_bytes=budget),)
                    + r[3:] for inst, r, _ in made[:2]]
    want_blocked = np.asarray(rj.greedy_fanout_grid_jax(blocked_rows))
    shard = tgr._DenseShard(rows, torch.device("cpu"))
    shard.run()
    got = shard.starts().numpy()
    got_blocked = []
    for inst, r, _ in made[:2]:
        blp = tgr.BlockedLP(interop.port(inst), budget_bytes=budget)
        assert blp.chunk_width(len(COMBOS), NP) == CHUNK
        got_blocked.append(tgr._blocked_fanout_padded(
            *r[:2], blp, *r[3:], device="cpu").numpy())
    return made, want, got, want_blocked, np.stack(got_blocked)


@pytest.mark.parametrize("case", range(len(GREEDY_CASES)),
                         ids=[c[3] for c in GREEDY_CASES])
def test_greedy_scan_plain_matches_jax(greedy_grid, case):
    made, want, got, _, _ = greedy_grid
    inst, row, v0 = made[case]
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got[case], want[case])
    N = inst.num_tasks
    # padded tasks are zero-width and placed last, at t = 0 (est 0)
    assert (got[case][..., N:] == 0).all()
    edge = GREEDY_CASES[case][3]
    if edge == "no_feasible_unit":
        first = row[7][:, 0]
        assert np.array_equal(got[case][0, np.arange(len(COMBOS)), first],
                              row[5][first])
    elif edge == "overrun":
        assert (got[case][:, :, v0] + inst.dur[v0] > TP).all()
    elif edge == "flat_budget":
        assert set(np.unique(row[3][0]).tolist()) == {0, 7}   # 0: padding


@pytest.mark.parametrize("case", range(2), ids=[c[3] for c in
                                                GREEDY_CASES[:2]])
def test_blocked_greedy_scan_plain_matches_jax_and_dense(greedy_grid, case):
    """One scan call per chunk of CHUNK steps (NP / CHUNK calls), fed the
    chunk's lp rows and columns: bitwise the reference's chunked scan and
    the dense scan."""
    _, want, got, want_blocked, got_blocked = greedy_grid
    assert np.array_equal(got_blocked[case], want_blocked[case])
    assert np.array_equal(got_blocked[case], got[case])
    assert np.array_equal(want_blocked[case], want[case])


def _climb_case():
    """The climb's crafted input: every (profile, combo) row of an instance
    with the first rows' starts moved off their greedy places (inverted
    windows), one row whose budget no move can improve (it stops after one
    round while the others climb), a commit width of 3 and 3 rounds."""
    inst, T, budgets, starts, _ = _rows("atacseq", seed=1)
    rng = np.random.default_rng(5)
    starts = starts.copy()
    for r in range(4):
        pick = rng.choice(inst.num_tasks, 12, replace=False)
        starts[r, pick] = np.clip(starts[r, pick] + rng.integers(-6, 7, 12),
                                  0, T - inst.dur[pick])
    budgets = budgets.copy()
    budgets[5] += 10 ** 6              # no deficit: no positive gain
    return inst, T, budgets, starts


@pytest.fixture(scope="module")
def climb_case():
    return _climb_case()


@pytest.mark.parametrize("adjacency", ["dense", "padded"])
def test_climb_with_commit_scan_matches_jax(climb_case, adjacency):
    inst, T, budgets, starts = climb_case
    mu, max_rounds, commit_k = smoke.SCAN_MU, 3, 3
    rem, st, dur, work, Np = _padded(inst, T, budgets, starts)
    padded = adjacency == "padded"
    want_s, want_r = rl._climb_impl(mu, max_rounds, commit_k, padded)(
        jnp.asarray(rem), jnp.asarray(st), jnp.int32(T), jnp.asarray(dur),
        jnp.asarray(work), *_ref_adjacency(inst, Np, padded))
    adj = tl._device_adjacency(interop.port(inst), {}, Np, padded,
                               torch.device("cpu"))
    got_s, got_r = tl.climb(
        torch.from_numpy(rem.copy()), torch.from_numpy(st.copy()), T,
        torch.from_numpy(dur), torch.from_numpy(work), adj, mu=mu,
        max_rounds=max_rounds, commit_k=commit_k)
    assert np.array_equal(np.asarray(want_s), got_s.numpy())
    assert np.array_equal(np.asarray(want_r), got_r.numpy())
    rounds = got_r.numpy()
    assert rounds[5] == 1                    # stopped after one round
    assert rounds.max() == max_rounds        # others hit the budget

    # the crafted edges are there in the first round
    start = torch.from_numpy(st.copy())
    d = torch.from_numpy(dur)
    lo, succ_hi = adj.bounds(start, d, T)
    assert bool((lo > succ_hi - d).any())    # an inverted window
    _, _, gain = smoke.commit_round(torch.from_numpy(rem), start, d,
                                    torch.from_numpy(work), adj, T, k=Np)
    assert int((gain > 0).sum(dim=1).max()) > commit_k


def _greedy_args(R=3, Np=8, Tp=16, I=1):
    z = torch.zeros
    return (z(R, Tp, dtype=torch.int32), z(R, Tp + 1, dtype=torch.bool),
            z(R, Np, dtype=torch.int32), z(R, Np, dtype=torch.int32),
            z(R, Np, dtype=torch.int32),
            torch.arange(Np, dtype=torch.int32).repeat(R, 1),
            z(I, Np, dtype=torch.int32), z(I, Np, dtype=torch.int32),
            z(R, dtype=torch.int32), z(I, Np, Np, dtype=torch.int32),
            z(I, Np, Np, dtype=torch.int32))


def _commit_args(R=3, Np=8, Tp=16, K=4):
    z = torch.zeros
    adj = tcs.DenseAdjacency(z(Np, Np, dtype=torch.bool),
                             z(Np, Np, dtype=torch.bool))
    return (z(R, Tp, dtype=torch.int32), z(R, Np, dtype=torch.int32),
            torch.arange(K).repeat(R, 1), z(R, Np, dtype=torch.int32),
            torch.ones(R, Np), torch.ones(R, dtype=torch.bool),
            torch.ones(Np, dtype=torch.int32),
            torch.ones(Np, dtype=torch.int32), Tp, adj)


@pytest.mark.parametrize("fn,args", [(tgs.greedy_scan, _greedy_args),
                                     (tcs.commit_scan, _commit_args)],
                         ids=["greedy_scan", "commit_scan"])
def test_modes_on_cpu_tensors(fn, args):
    """mode="kernel" on CPU tensors raises, an unknown mode raises, and the
    auto mode runs the plain version: no launch is counted."""
    module = tgs if fn is tgs.greedy_scan else tcs
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*args(), mode="kernel")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        fn(*args(), mode="fast")
    before = module.LAUNCHES
    fn(*args())
    fn(*args(), mode="plain")
    assert module.LAUNCHES == before


def test_cpu_plan_launches_neither_kernel():
    """A torch-engine plan on the CPU runs both loops' plain versions."""
    from repro_torch.api import Planner, PlanRequest

    plat = make_cluster(1, seed=4)
    wf = make_workflow("eager", 2, seed=4)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    prof = generate_profile("S1", deadline_from_asap(inst, 2.0), plat, J=12,
                            seed=4)
    before = (tgs.LAUNCHES, tcs.LAUNCHES)
    res = Planner(interop.port(plat), engine="torch", device="cpu").plan(
        PlanRequest(instances=interop.port(inst),
                    profiles=[interop.port(prof)] * 2))
    assert res.engine == "torch"
    assert (tgs.LAUNCHES, tcs.LAUNCHES) == before


# --- on the card -------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    return torch.device("cuda")


def _matrix_bucket(dev):
    """The plan's largest bucket (Np=4352, Tp=1024), as ``chip_smoke.py``'s
    [kernels] builds it: atacseq of the section 6.1 matrix against S1-S4,
    the 8 greedy combos (R=32 rows); the port's own modules only."""
    plat, insts, grid = smoke.build_matrix(("atacseq",))
    inst, T = insts[0], grid[0][0].T
    assert tgr.pad_dims(inst.num_tasks, T) == (4352, 1024)
    row, g = smoke.own_bucket_row(plat, inst, grid[0], dev)
    return inst, T, g, row


@pytest.mark.cuda
def test_cuda_greedy_scan_matches_plain_at_the_matrix_bucket():
    dev = _cuda()
    inst, T, g, row = _matrix_bucket(dev)
    before = tgs.LAUNCHES
    kern, err = smoke.same_greedy([row], dev, "at the bucket")
    assert err == 0.0
    assert tgs.LAUNCHES == before + 1
    assert kern.start.shape == (32, 4352)
    # the blocked form, 17 chunks of 256 steps, a launch each, against the
    # dense scan
    budget = tgr.lp_block_bytes(256, 8, 4352)
    blp = tgr.BlockedLP(inst, budget_bytes=budget)
    assert blp.chunk_width(8, 4352) == 256
    blocked = tgr._blocked_fanout_padded(*row[:2], blp, *row[3:],
                                         device=dev)
    assert tgs.LAUNCHES == before + 1 + 4352 // 256
    assert torch.equal(blocked.reshape(32, 4352), kern.start)


@pytest.mark.cuda
@pytest.mark.parametrize("R,Np,Tp", [(3, 256, 1024),        # all in smem
                                     (2, 30720, 1024),      # est/lst global
                                     (2, 512, 60000)],      # all global
                         ids=["shared", "tasks_global", "all_global"])
def test_cuda_greedy_scan_matches_plain_off_the_plan(R, Np, Tp):
    """Random inputs of the blocked form's layout, from the first step and
    from the last chunk's."""
    dev = _cuda()
    steps = 24
    state, rest = smoke.synthetic_greedy(R, Np, Tp, steps, Np + Tp, dev)
    for t0 in (0, Np - steps):
        assert smoke.same_scans(state, rest, t0, f"t0={t0}") == 0.0


@pytest.mark.cuda
def test_cuda_greedy_scan_edge_cases_match_plain():
    """Flat budgets, no feasible unit, a task past the padded horizon, and
    padded tasks, on a small instance of the port's own generators."""
    dev = _cuda()
    row, v0, d0 = smoke.greedy_edge_row(dev)
    kern, err = smoke.same_greedy([row, row], dev, "on the edge case")
    assert err == 0.0
    assert (kern.starts()[..., v0] + d0 > kern.rem.shape[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("adjacency,k", [("dense", 32), ("padded", 32),
                                         ("dense", 3)])
def test_cuda_commit_scan_matches_plain_at_the_matrix_bucket(adjacency, k):
    """Three climb rounds on the bucket's greedy starts, each round's
    commits through the kernel and the plain version from the same state;
    row 5 dead, rows 0-3 moved off their greedy places."""
    dev = _cuda()
    inst, T, g, row = _matrix_bucket(dev)
    shard = tgr._DenseShard([row], dev)
    shard.run()
    N = inst.num_tasks
    starts = smoke.moved_starts(
        inst, T, shard.start[:, :N].cpu().numpy().astype(np.int64))
    budgets = np.repeat(np.asarray(row[3])[:, :T], 8, axis=0) \
        .astype(np.int64)
    state = smoke.climb_rows(inst, T, budgets, starts, 32, 1024, 4352, dev)
    dur, work = shard.dur[0], shard.work[0]
    adj = tl._device_adjacency(inst, g.ls_graph, 4352,
                               adjacency == "padded", dev)
    live = torch.ones(32, dtype=torch.bool, device=dev)
    live[5] = False
    for r in range(3):
        rnd = smoke.commit_round(*state, dur, work, adj, T, k=k)
        rem, st, any_c, err = smoke.same_commits(state, rnd, live, dur, work,
                                                 T, adj, f"round {r}")
        assert err == 0.0
        assert not bool(any_c[5])
        state = (rem, st)


@pytest.mark.cuda
@pytest.mark.parametrize("R,Np,Tp,D", [(4, 60000, 512, 8),       # global
                                       (6, 300, 2048, 16)])      # smem
def test_cuda_commit_scan_matches_plain_off_the_plan(R, Np, Tp, D):
    """Random padded-CSR adjacency and proposals, a dead row, inverted
    windows; at Np + Tp past shared memory the state stays in device
    memory."""
    dev = _cuda()
    *_, any_c, err = smoke.same_commits(
        *smoke.synthetic_commit(R, Np, Tp, D, dev), f"R={R} Np={Np}")
    assert err == 0.0
    assert bool(any_c.any()) and not bool(any_c[1])


# --- the ring's edges, on the card -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("R,Np,Tp", [(2, 64, 96), (2, 30720, 1024)],
                         ids=["below_one_stage", "ragged_chunks"])
def test_cuda_greedy_scan_ring_chunks_match_plain(R, Np, Tp):
    """A row shorter than a stage and than the block (most threads own no
    unit), and a row the ring carries in chunks whose last one is short."""
    dev = _cuda()
    plan = tgs.ring_plan(Np, Tp, dev)
    if Np == 64:
        assert plan["chunk"] == Np and plan["stage_tasks"]
    else:
        assert plan["chunk"] < Np and Np % plan["chunk"] != 0
        assert not plan["stage_tasks"] and plan["stage_time"]
    state, rest = smoke.synthetic_greedy(R, Np, Tp, 24, Np + Tp, dev)
    for t0 in (0, Np - 24):
        assert smoke.same_scans(state, rest, t0, f"t0={t0}") == 0.0


@pytest.mark.cuda
def test_cuda_greedy_scan_launches_shorter_than_the_ring():
    """Blocked chunks of 1 and 2 steps, fewer than the ring's stages, alone
    and chained (each launch from the state the last one left)."""
    dev = _cuda()
    Np, Tp = 256, 1024
    assert tgs.ring_plan(Np, Tp, dev)["stages"] > 2
    state, rest = smoke.synthetic_greedy(3, Np, Tp, 24, 7, dev)
    for n in (1, 2):
        for t0 in (0, Np - 24):
            assert smoke.same_scans(state, rest, t0, f"{n} steps",
                                    t1=t0 + n) == 0.0
    outs = []
    for mode in ("kernel", "plain"):
        s, t = [x.clone() for x in state], 0
        for n in (1, 2, 1, 2, 2, 1):
            tgs.greedy_scan(*s, *rest[:4], rest[4][:, t:t + n].contiguous(),
                            rest[5][:, t:t + n].contiguous(), lp_of=rest[6],
                            t0=t, mode=mode)
            t += n
        outs.append(s)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.cuda
def test_cuda_scan_kernels_refuse_ragged_rows():
    """Np % 4 != 0 (greedy) and a dense Np % 16 != 0 (commit): the kernels'
    bulk copies cannot take the rows, so the kernel path raises a
    ValueError; the plain versions take them."""
    dev = _cuda()
    state, rest = smoke.synthetic_greedy(2, 250, 128, 4, 3, dev)
    with pytest.raises(ValueError, match="Np % 4 == 0"):
        tgs.greedy_scan(*[x.clone() for x in state], *rest[:6],
                        lp_of=rest[6], mode="kernel")
    tgs.greedy_scan(*[x.clone() for x in state], *rest[:6], lp_of=rest[6],
                    mode="plain")
    state, rnd, live, dur, work, t_real, adj = smoke.synthetic_dense_commit(
        3, 300, 512, dev)
    with pytest.raises(ValueError, match="Np % 16 == 0"):
        tcs.commit_scan(*[x.clone() for x in state], *rnd, live, dur, work,
                        t_real, adj, mode="kernel")
    tcs.commit_scan(*[x.clone() for x in state], *rnd, live, dur, work,
                    t_real, adj, mode="plain")


@pytest.mark.cuda
@pytest.mark.parametrize("adjacency", ["dense", "padded"])
@pytest.mark.parametrize("k", [1, 16])
def test_cuda_commit_scan_few_proposals_match_plain(adjacency, k):
    """K=1, and rows with 0 to 9 positive proposals (fewer than the dense
    ring is deep: it must not wait on a stage it never fills), a dead
    row."""
    dev = _cuda()
    R, Np, Tp = 10, 512, 1024
    if adjacency == "dense":
        case = smoke.synthetic_dense_commit(R, Np, Tp, dev)
    else:
        case = smoke.synthetic_commit(R, Np, Tp, 8, dev)
    state, rnd, live, dur, work, t_real, adj = case
    cut = smoke.few_positives(rnd, k)
    assert int((cut[2] > 0).sum(dim=1).max()) == R - 1
    *_, any_c, err = smoke.same_commits(state, cut, live, dur, work, t_real,
                                        adj, f"{adjacency} K={k}")
    assert err == 0.0
    assert not bool(any_c[0]) and not bool(any_c[1])


@pytest.mark.cuda
def test_cuda_commit_scan_dense_hub_tasks_match_plain():
    """Dense rows with many predecessors and successors (three quarters,
    all, all) at the bucket's Np, visited first by every live row."""
    dev = _cuda()
    *_, any_c, err = smoke.same_commits(
        *smoke.synthetic_dense_commit(6, 4352, 1024, dev), "hub tasks")
    assert err == 0.0
    assert bool(any_c.any()) and not bool(any_c[1])
