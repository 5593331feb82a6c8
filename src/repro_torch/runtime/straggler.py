"""Straggler detection/mitigation: EWMA step-time monitor.

At fleet scale, slow hosts show up as step-time inflation on their pod. The
monitor tracks an EWMA + variance of per-pod step times and emits a
mitigation decision when a pod's time exceeds ``z_thresh`` deviations: first
"rebalance" (shift microbatches away), then "evict" (drop the pod and
trigger an elastic re-mesh) after ``evict_after``
consecutive flags. The port has no elastic re-mesh yet (it comes with the
training slice), so "evict" is a decision for the caller to act on.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Decision:
    pod: int
    action: str          # ok | rebalance | evict
    ratio: float


class StragglerMonitor:
    def __init__(self, n_pods: int, alpha: float = 0.2,
                 z_thresh: float = 3.0, evict_after: int = 5):
        self.n = n_pods
        self.alpha = alpha
        self.z = z_thresh
        self.evict_after = evict_after
        self.mean = [None] * n_pods
        self.var = [0.0] * n_pods
        self.flags = [0] * n_pods

    def observe(self, pod: int, seconds: float) -> Decision:
        m = self.mean[pod]
        if m is None:
            self.mean[pod] = seconds
            return Decision(pod, "ok", 1.0)
        d = seconds - m
        sd = max(self.var[pod] ** 0.5, 0.02 * max(m, 1e-9))
        ratio = seconds / max(m, 1e-9)
        flagged = d > self.z * sd and ratio > 1.2
        if flagged:
            # do not fold anomalies into the baseline estimate
            self.flags[pod] += 1
            if self.flags[pod] >= self.evict_after:
                return Decision(pod, "evict", ratio)
            return Decision(pod, "rebalance", ratio)
        self.mean[pod] = m + self.alpha * d
        self.var[pod] = (1 - self.alpha) * (self.var[pod]
                                            + self.alpha * d * d)
        self.flags[pod] = 0
        return Decision(pod, "ok", ratio)
