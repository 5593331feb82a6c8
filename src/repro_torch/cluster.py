"""Target platform model (paper §3 + §6.1, Table 1).

A cluster of ``P`` heterogeneous compute processors plus ``P*(P-1)``
fictional link processors (one per directed link of the fully connected,
full-duplex topology). Link processors execute communication tasks in the
communication-enhanced DAG ``G_c``.

Processor ids: ``0..P-1`` are compute processors; link ``(a, b)``, ``a != b``
gets id ``P + a*(P-1) + (b if b < a else b-1)``; ``num_procs = P*P``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Table 1 of the paper: (name, speed, P_idle, P_work)
PROCESSOR_TABLE = (
    ("PT1", 4, 40, 10),
    ("PT2", 6, 60, 30),
    ("PT3", 8, 80, 40),
    ("PT4", 12, 120, 50),
    ("PT5", 16, 150, 70),
    ("PT6", 32, 200, 100),
)


@dataclasses.dataclass(frozen=True)
class Platform:
    """A heterogeneous cluster with compute and link processors."""

    speed: np.ndarray        # [P] normalized compute speed
    p_idle: np.ndarray       # [P*P] idle power (compute + links)
    p_work: np.ndarray       # [P*P] active power  (compute + links)
    type_of: np.ndarray      # [P] index into PROCESSOR_TABLE (for reporting)

    @property
    def num_compute(self) -> int:
        return len(self.speed)

    @property
    def num_procs(self) -> int:
        return len(self.p_idle)

    def link_id(self, a: int, b: int) -> int:
        """Fictional processor id for directed link a -> b (a != b)."""
        P = self.num_compute
        assert a != b
        return P + a * (P - 1) + (b if b < a else b - 1)

    @property
    def idle_total(self) -> int:
        """Constant idle draw of the whole platform, per time unit.

        The paper sums P_idle of every processor at every time unit
        (Eq. (23)); since this is schedule-independent it folds into an
        *effective* green budget ``G_j - idle_total``.
        """
        return int(self.p_idle.sum())

    def exec_time(self, node_w: np.ndarray, proc: np.ndarray) -> np.ndarray:
        """Integer running times of tasks with weights node_w mapped on proc."""
        t = np.ceil(np.asarray(node_w, dtype=np.float64)
                    / self.speed[np.asarray(proc)]).astype(np.int64)
        return np.maximum(t, 1)


def make_cluster(nodes_per_type: int, seed: int = 0,
                 link_power: bool = True) -> Platform:
    """Build the paper's clusters: ``small`` = 12 nodes/type, ``large`` = 24.

    Link processors draw P_idle, P_work ~ U{1, 2} (paper §6.1); pass
    ``link_power=False`` for the UCAS-style zero-power links used in the
    complexity-reduction tests.
    """
    rng = np.random.default_rng(seed)
    P = nodes_per_type * len(PROCESSOR_TABLE)
    speed = np.empty(P, dtype=np.int64)
    type_of = np.empty(P, dtype=np.int64)
    p_idle = np.zeros(P * P, dtype=np.int64)
    p_work = np.zeros(P * P, dtype=np.int64)
    for t, (_, sp, pi, pw) in enumerate(PROCESSOR_TABLE):
        sl = slice(t * nodes_per_type, (t + 1) * nodes_per_type)
        speed[sl] = sp
        type_of[sl] = t
        p_idle[sl] = pi
        p_work[sl] = pw
    if link_power:
        n_links = P * P - P
        p_idle[P:] = rng.integers(1, 3, size=n_links)
        p_work[P:] = rng.integers(1, 3, size=n_links)
    return Platform(speed=speed, p_idle=p_idle, p_work=p_work, type_of=type_of)


def make_uniform_platform(P: int) -> Platform:
    """UCAS platform of Theorem 4.3: P_idle = 0, P_work = 1, no comm power."""
    return Platform(
        speed=np.ones(P, dtype=np.int64),
        p_idle=np.zeros(P * P, dtype=np.int64),
        p_work=np.concatenate([np.ones(P, dtype=np.int64),
                               np.zeros(P * P - P, dtype=np.int64)]),
        type_of=np.zeros(P, dtype=np.int64),
    )


SMALL_CLUSTER_NODES_PER_TYPE = 12
LARGE_CLUSTER_NODES_PER_TYPE = 24
