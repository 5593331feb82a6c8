"""CarbonGate: the paper's scheduler driving the training loop.

The port of ``repro.runtime.carbon_gate``; the gate's planner runs on the
card unless it is given ``device="cpu"``.

The training run is divided into fixed *step chunks*; each chunk is a task
of the paper's scheduling problem — the chunks on one pod form a chain (a
fixed mapping + total order, exactly the paper's setting), chunk duration
comes from the measured/estimated step time, and power draw is
``chips * chip_watts``. CaWoSched then assigns chunk start times inside the
green windows of the site's power profile, and the gate sleeps (simulated
or wall-clock) until each chunk's scheduled start.

Multi-pod runs build one chain per pod over the same profile; cross-pod
checkpoint barriers become chain-to-chain edges.

Forecasts are uncertain: the gate optionally plans against an ensemble of
perturbed profiles (``profiles=...``) through the multi-profile portfolio
engine — every variant scored against every member in one batched device
pass — and executes the robust (min-max) variant.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api import Planner, PlanRequest
from repro_torch.cluster import Platform
from repro_torch.core.carbon import PowerProfile
from repro_torch.core.dag import FixedMapping, Instance, build_instance
from repro_torch.kernels.backend import resolve_engine
from repro_torch.workflows.generators import Workflow


def fleet_platform(pods: int, chip_watts_idle: float, chip_watts_work: float,
                   chips_per_pod: int) -> Platform:
    """A Platform whose 'processors' are pods of an accelerator fleet."""
    speed = np.ones(pods, dtype=np.int64)
    p_idle = np.zeros(pods * pods, dtype=np.int64)
    p_work = np.zeros(pods * pods, dtype=np.int64)
    p_idle[:pods] = int(chip_watts_idle * chips_per_pod)
    p_work[:pods] = int(chip_watts_work * chips_per_pod)
    return Platform(speed=speed, p_idle=p_idle, p_work=p_work,
                    type_of=np.zeros(pods, dtype=np.int64))


def chunk_workflow(n_chunks_per_pod: list[int],
                   chunk_seconds: list[list[int]],
                   barriers: list[int] | None = None) -> tuple[Workflow, FixedMapping]:
    """Chains of step-chunks (one chain per pod) + optional barrier edges."""
    node_w = []
    edges = []
    proc = []
    order: list[list[int]] = []
    nid = 0
    chain_ids = []
    for p, n in enumerate(n_chunks_per_pod):
        ids = []
        for c in range(n):
            node_w.append(max(int(chunk_seconds[p][c]), 1))
            proc.append(p)
            if ids:
                edges.append((ids[-1], nid))
            ids.append(nid)
            nid += 1
        chain_ids.append(ids)
        order.append(ids)
    if barriers:
        # at barrier index k, all pods must have finished chunk k before any
        # pod starts chunk k+1 (checkpoint-consistency barrier)
        for k in barriers:
            for a in range(len(chain_ids)):
                for b in range(len(chain_ids)):
                    if a != b and k + 1 < len(chain_ids[b]) and k < len(chain_ids[a]):
                        edges.append((chain_ids[a][k], chain_ids[b][k + 1]))
    wf = Workflow(
        name="train-chunks",
        node_w=np.asarray(node_w, dtype=np.int64),
        edges=np.asarray(edges, dtype=np.int64).reshape(-1, 2),
        edge_w=np.ones(len(edges), dtype=np.int64))
    proc_arr = np.asarray(proc, dtype=np.int64)
    # cross-pod barrier edges become (cheap) sync communications on the
    # pod-to-pod links, ordered by source chunk index
    pods = len(n_chunks_per_pod)
    comm_order: dict[int, list[tuple[int, int]]] = {}
    for (u, v) in sorted(map(tuple, edges)):
        if proc_arr[u] != proc_arr[v]:
            a, b = int(proc_arr[u]), int(proc_arr[v])
            link = pods + a * (pods - 1) + (b if b < a else b - 1)
            comm_order.setdefault(link, []).append((int(u), int(v)))
    mapping = FixedMapping(
        proc=proc_arr,
        order=tuple(tuple(o) for o in order),
        comm_order={k: tuple(v) for k, v in comm_order.items()})
    return wf, mapping


@dataclasses.dataclass
class GatePlan:
    instance: Instance
    profile: PowerProfile
    start: np.ndarray           # scheduled chunk start times (seconds)
    cost: int                   # cost under the nominal profile
    asap_cost: int
    variant: str = ""           # the variant the plan executes
    robust_cost: int | None = None    # chosen variant's worst ensemble cost
    cost_matrix: np.ndarray | None = None   # [P, V] ensemble x variant costs
    variant_names: tuple = ()


class CarbonGate:
    """Plan + gate execution of training-step chunks into green windows.

    ``profiles`` optionally extends the nominal forecast with a
    perturbation ensemble (forecast-uncertainty members). Planning then
    runs the multi-profile portfolio engine — every variant against every
    member, one batched device pass under ``engine="torch"`` — and
    executes the
    *robust* variant: the one minimizing the worst-case cost across the
    ensemble. ``variant`` pins a specific heuristic instead ("auto" =
    robust pick; with a single profile "auto" simply picks the cheapest).
    ``device`` is where the gate's :class:`Planner` runs (None = the
    card).
    """

    def __init__(self, profile: PowerProfile, platform: Platform,
                 variant: str = "pressWR-LS",
                 profiles: list[PowerProfile] | None = None,
                 engine: str = "auto", device=None):
        self.profile = profile
        self.platform = platform
        self.variant = variant
        self.profiles = [profile] + [p for p in (profiles or [])
                                     if p is not profile]
        # engine="auto" centrally resolved: the device fan-out pays off as
        # soon as there is an ensemble to score
        self.engine = resolve_engine(engine, fanout=len(self.profiles))
        self.planner = Planner(platform, engine=self.engine, device=device)
        self.plan: GatePlan | None = None

    def _variants(self):
        return None if self.variant == "auto" \
            else tuple(dict.fromkeys(("asap", self.variant)))

    def make_plan(self, chunk_seconds: list[list[int]],
                  barriers: list[int] | None = None) -> GatePlan:
        wf, mapping = chunk_workflow(
            [len(c) for c in chunk_seconds], chunk_seconds, barriers)
        inst = build_instance(wf, mapping, self.platform,
                              dur=wf.node_w)
        res = self.planner.plan(PlanRequest(
            instances=inst, profiles=self.profiles,
            variants=self._variants(), robust=True))
        costs, names = res.cost_matrix(0)
        chosen, worst_cost = res.robust(0)
        nominal = res.results[0][0]
        self.plan = GatePlan(
            instance=inst, profile=self.profile,
            start=nominal[chosen].start, cost=nominal[chosen].cost,
            asap_cost=nominal["asap"].cost, variant=chosen,
            robust_cost=worst_cost, cost_matrix=costs,
            variant_names=names)
        return self.plan

    def replan_session(self, chunk_seconds: list[list[int]],
                       window_profiles, n_windows: int | None = None,
                       barriers: list[int] | None = None, lookahead: int = 1):
        """Async rolling-horizon replanning of this gate's chunk workflow.

        ``window_profiles`` is the per-window forecast source (callable
        ``k -> profiles`` or a sequence); every window's forecast must
        share one horizon so the chunk instance's PreparedGraph is reused
        across windows. Returns a :class:`repro_torch.api.PlanningSession`
        planning window k+1 while window k executes.
        """
        wf, mapping = chunk_workflow(
            [len(c) for c in chunk_seconds], chunk_seconds, barriers)
        inst = build_instance(wf, mapping, self.platform, dur=wf.node_w)
        return self.planner.session(
            inst, window_profiles, n_windows=n_windows,
            variants=self._variants(), robust=True, lookahead=lookahead)

    def wait_time(self, pod: int, chunk: int, now: float) -> float:
        """Seconds to sleep before running this chunk (0 if already due)."""
        assert self.plan is not None
        chain = self.plan.instance.proc_chains[pod]
        task = chain[chunk]
        return max(float(self.plan.start[task]) - now, 0.0)
