"""Dynamic sub-stage partitioning + the Eq. (1) time budget.

The paper sets the retrieval sub-stage time budget ``mb`` by maximising the
expected latency improvement

    Delta_l(mb) = (t_Retrieval - mb) / 2  -  (t_Retrieval / mb) * beta

(first term: expected wait-time reduction when a stage can join mid-flight;
second term: scheduling/intermediate-result overhead of the extra
sub-stages; the paper's printed formula adds the overhead term — a sign typo,
since the stated argmax then has no interior optimum).  Setting the
derivative to zero gives the closed form

    mb* = sqrt(2 * t_Retrieval * beta)

``t_Retrieval`` and ``beta`` are measured online (EMA), so the budget adapts
to the live workload exactly as §4.2 describes.  Generation sub-stages are
sized to match: n_steps = clamp(mb / t_decode_step).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class TimeBudget:
    beta_us: float = 150.0  # per-sub-stage scheduling overhead (measured)
    t_retrieval_us: float = 20_000.0  # average full retrieval stage time (EMA)
    t_decode_step_us: float = 1_000.0  # per decode step (EMA, batch-dependent)
    ema: float = 0.9
    min_budget_us: float = 200.0
    max_budget_us: float = 200_000.0

    def observe_retrieval_stage(self, t_us: float) -> None:
        self.t_retrieval_us = self.ema * self.t_retrieval_us + (1 - self.ema) * t_us

    def observe_decode_step(self, t_us: float) -> None:
        self.t_decode_step_us = self.ema * self.t_decode_step_us + (1 - self.ema) * t_us

    def observe_beta(self, t_us: float) -> None:
        self.beta_us = self.ema * self.beta_us + (1 - self.ema) * t_us

    @property
    def mb_us(self) -> float:
        mb = math.sqrt(2.0 * max(self.t_retrieval_us, 1e-9) * max(self.beta_us, 1e-9))
        return min(max(mb, self.min_budget_us), self.max_budget_us)

    def delta_l(self, mb_us: float) -> float:
        """Expected latency improvement at a given budget (for analysis)."""
        return (self.t_retrieval_us - mb_us) / 2.0 - (
            self.t_retrieval_us / max(mb_us, 1e-9)
        ) * self.beta_us

    # ---------------------------------------------------------------- sizing
    def gen_steps_for_budget(self, batch_hint: int = 1) -> int:
        n = int(self.mb_us / max(self.t_decode_step_us, 1.0))
        return max(1, min(n, 64))

    def units_for_budget(self, unit_costs) -> int:
        """Generic Eq.(1) sizing for any splittable stage: admit work units
        (clusters, candidate blocks, query variants, ...) from the head of
        the queue until the budget fills; at least one unit always fits so
        progress is guaranteed.  Stage specs hand in their per-unit cost
        profile (see core/stages.py)."""
        budget = self.mb_us
        used = 0.0
        n = 0
        for c in unit_costs:
            if n > 0 and used + c > budget:
                break
            used += c
            n += 1
        return max(n, 1) if len(unit_costs) else 0

    def clusters_for_budget(self, cluster_queue, cost_model, sizes) -> int:
        """Incrementally admit clusters until the budget is filled (§4.2):
        returns how many clusters from the head of the queue fit in mb."""
        return self.units_for_budget(
            [cost_model.cost_us(int(sizes[cid])) for cid in cluster_queue])
