"""Workload profiles: arrival processes, prompt/generation length
distributions, iteration counts — the knobs behind paper Figs. 6/12/14.

Lengths are sampled per (request, node) with deterministic seeds so a run is
reproducible and sim/real modes see the same workload.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WorkloadProfile:
    name: str = "default"
    prompt_tokens_mean: float = 96.0
    prompt_tokens_sigma: float = 0.4  # lognormal sigma
    gen_tokens_mean: float = 96.0  # per generation stage
    gen_tokens_sigma: float = 0.6  # heavy-ish tail (paper Fig. 6a)
    max_gen_tokens: int = 512
    iterations_mean: float = 2.5  # rounds for iterative workflows
    iterations_max: int = 5
    # per-request latency SLO (us); mean 0 -> no per-request SLO, the
    # scheduler falls back to SchedulerConfig.slo_us for every request
    slo_us_mean: float = 0.0
    slo_us_sigma: float = 0.0  # lognormal spread of per-request deadlines
    # per-workflow-class SLO tiers (workflow/graph name -> deadline us);
    # a matching class overrides the sampled per-request SLO, which is how
    # a heterogeneous mix gives interactive one-shot traffic a tight
    # deadline while multi-hop workflows get a loose one
    slo_class_us: dict = dataclasses.field(default_factory=dict)
    seed: int = 7

    def _rng(self, request_id: int, node_id: int, tag: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, request_id, node_id, tag])
        )

    def prompt_tokens(self, request_id: int, node_id: int) -> int:
        r = self._rng(request_id, node_id, 0)
        v = r.lognormal(np.log(self.prompt_tokens_mean), self.prompt_tokens_sigma)
        return int(np.clip(v, 8, 4 * self.prompt_tokens_mean))

    def gen_tokens(self, request_id: int, node_id: int, cap: int) -> int:
        r = self._rng(request_id, node_id, 1)
        v = r.lognormal(np.log(self.gen_tokens_mean), self.gen_tokens_sigma)
        return int(np.clip(v, 4, min(cap, self.max_gen_tokens)))

    def iterations(self, request_id: int) -> int:
        r = self._rng(request_id, 0, 2)
        v = 1 + r.poisson(max(self.iterations_mean - 1.0, 0.0))
        return int(np.clip(v, 1, self.iterations_max))

    def slo_us(self, request_id: int, workflow: str | None = None) -> float:
        """Per-request deadline length; 0.0 means 'use the server default'.
        A workflow whose class has an ``slo_class_us`` tier gets that tier's
        deadline; otherwise the (lognormal) per-request sample applies."""
        if workflow is not None and workflow in self.slo_class_us:
            return float(self.slo_class_us[workflow])
        if self.slo_us_mean <= 0.0:
            return 0.0
        if self.slo_us_sigma <= 0.0:
            return float(self.slo_us_mean)
        r = self._rng(request_id, 0, 3)
        return float(r.lognormal(np.log(self.slo_us_mean), self.slo_us_sigma))


def poisson_arrivals(rate_per_s: float, n: int, seed: int = 11) -> np.ndarray:
    """Arrival times (us) of a Poisson process with the given rate."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_per_s, 1e-9), size=n)
    return (np.cumsum(gaps) * 1e6).astype(np.float64)


# Named profiles for the three evaluation datasets (topic skew + hop count
# differ; values chosen to reproduce the qualitative contrasts of §6).
PROFILES = {
    "nq": WorkloadProfile("nq", gen_tokens_mean=72, iterations_mean=1.6),
    "wikiqa": WorkloadProfile("wikiqa", gen_tokens_mean=96, iterations_mean=2.6),
    "hotpotqa": WorkloadProfile("hotpotqa", gen_tokens_mean=112, iterations_mean=3.0),
}


# ---------------------------------------------------------------------------
# Heterogeneous-mix load generation (streaming serving)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamItem:
    """One open-loop arrival: consumed by ``Server.serve`` / ``submit``."""
    arrival_us: float
    workflow: str
    text: str = ""


@dataclasses.dataclass
class MixSpec:
    """A heterogeneous request mix: sampling weights over workflow classes
    plus optional per-class SLO tiers — the paper's headline scenario of a
    sustained stream mixing one-shot/HyDE/multistep/IRG/recomp traffic with
    differing deadlines.

    ``sample`` draws a deterministic open-loop Poisson stream (class choice
    and inter-arrival gaps both seeded), ``profile`` stamps the SLO tiers
    onto a WorkloadProfile so the scheduler and the admission layer see the
    per-class deadlines.
    """

    name: str = "mixed"
    # workflow name -> relative weight; empty = uniform over the names given
    weights: dict = dataclasses.field(default_factory=dict)
    # workflow name -> deadline us (copied into WorkloadProfile.slo_class_us)
    slo_tiers_us: dict = dataclasses.field(default_factory=dict)
    seed: int = 13

    def classes(self) -> list[str]:
        return sorted(self.weights)

    def sample(self, n: int, rate_per_s: float,
               seed: int | None = None) -> list[StreamItem]:
        """n arrivals of a Poisson stream at ``rate_per_s``, workflow classes
        drawn by weight.  Deterministic for a fixed (spec, seed)."""
        if not self.weights:
            raise ValueError(f"MixSpec {self.name!r} has no workflow weights")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed if seed is None else seed, n]))
        names = self.classes()
        w = np.asarray([self.weights[c] for c in names], np.float64)
        gaps = rng.exponential(1.0 / max(rate_per_s, 1e-9), size=n)
        arrivals = np.cumsum(gaps) * 1e6
        picks = rng.choice(len(names), size=n, p=w / w.sum())
        return [StreamItem(float(arrivals[i]), names[int(picks[i])], f"q{i}")
                for i in range(n)]

    def profile(self, base: WorkloadProfile | None = None) -> WorkloadProfile:
        """A WorkloadProfile carrying this mix's per-class SLO tiers."""
        return dataclasses.replace(base or WorkloadProfile(),
                                   name=self.name,
                                   slo_class_us=dict(self.slo_tiers_us))


# ---------------------------------------------------------------------------
# Closed-loop load generation (wall-clock serving front-end)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClientDraw:
    """One submission of a closed-loop client's plan: what to send, how long
    to think after the answer, and the token charge against the shared
    budget (est_tokens ~ prompt + expected generation)."""
    workflow: str
    text: str
    think_s: float
    est_tokens: int


@dataclasses.dataclass
class ClosedLoopSpec:
    """Closed-loop workload: ``num_clients`` clients each submit, wait for
    the finish, think, and repeat — the serving-system complement to the
    open-loop Poisson stream (offered load adapts to service rate instead
    of being fixed).  ``token_budget`` caps the *total* tokens the client
    population may charge (0 = unlimited), the standard way to bound a
    closed-loop run's length.

    ``plan(client_id)`` is a deterministic per-client draw sequence
    (seeded by (seed, client_id)); the *arrival instants* are wall-clock
    and recorded by the ingress trace — everything else about the
    workload replays from the plan.
    """

    name: str = "closed"
    # workflow name -> relative weight (same convention as MixSpec)
    weights: dict = dataclasses.field(default_factory=dict)
    num_clients: int = 4
    requests_per_client: int = 8
    think_time_s: float = 0.05  # mean of an exponential think time
    est_tokens_mean: float = 160.0  # per-request charge against the budget
    token_budget: int = 0  # total tokens across all clients; 0 = unlimited
    seed: int = 29

    @classmethod
    def from_mix(cls, mix: "MixSpec", **kw) -> "ClosedLoopSpec":
        """Closed-loop spec over a named mix's workflow weights."""
        kw.setdefault("seed", mix.seed)
        return cls(name=mix.name, weights=dict(mix.weights), **kw)

    def plan(self, client_id: int) -> list[ClientDraw]:
        """The full deterministic draw sequence of one client."""
        if not self.weights:
            raise ValueError(f"ClosedLoopSpec {self.name!r} has no weights")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(client_id)]))
        names = sorted(self.weights)
        w = np.asarray([self.weights[c] for c in names], np.float64)
        n = int(self.requests_per_client)
        picks = rng.choice(len(names), size=n, p=w / w.sum())
        thinks = rng.exponential(max(self.think_time_s, 1e-9), size=n)
        toks = rng.lognormal(np.log(max(self.est_tokens_mean, 1.0)), 0.4,
                             size=n)
        return [ClientDraw(workflow=names[int(picks[i])],
                           text=f"c{int(client_id)}q{i}",
                           think_s=float(thinks[i]),
                           est_tokens=int(max(1, toks[i])))
                for i in range(n)]


# Named mixes used by benchmarks/bench_serving.py and the examples.  Tier
# values follow the interactive-vs-batch contrast: one-shot/HyDE answer a
# user waiting at a prompt, multi-hop pipelines tolerate seconds.
MIXES = {
    "pure-oneshot": MixSpec(
        "pure-oneshot",
        weights={"one-shot": 1.0},
        slo_tiers_us={"one-shot": 2.5e6}),
    "balanced": MixSpec(
        "balanced",
        weights={"one-shot": 1.0, "hyde": 1.0, "multistep": 1.0,
                 "irg": 1.0, "recomp": 1.0},
        slo_tiers_us={"one-shot": 2.5e6, "hyde": 4e6, "recomp": 6e6,
                      "multistep": 10e6, "irg": 10e6}),
    "interactive-heavy": MixSpec(
        "interactive-heavy",
        weights={"one-shot": 6.0, "hyde": 2.0, "multistep": 1.0,
                 "irg": 1.0, "recomp": 2.0},
        slo_tiers_us={"one-shot": 2e6, "hyde": 3e6, "recomp": 5e6,
                      "multistep": 12e6, "irg": 12e6}),
    # retrieval-bound traffic (multi-hop pipelines dominate): the mix the
    # shard-mode serving sweep (benchmarks/bench_sharded_serving.py) uses —
    # retrieval-worker scaling and scatter-gather overheads only show when
    # probe volume, not decoding, is the bottleneck
    "retrieval-heavy": MixSpec(
        "retrieval-heavy",
        weights={"one-shot": 1.0, "multistep": 3.0, "irg": 3.0,
                 "recomp": 2.0},
        slo_tiers_us={"one-shot": 2.5e6, "recomp": 8e6,
                      "multistep": 12e6, "irg": 12e6}),
    # the stage-registry mix: the paper five plus the polymorphic stage
    # workflows (rerank / multiquery / hybrid / compress / pipeline), so the
    # goodput knee is measured on traffic whose host work is NOT just IVF
    # scans — cross-encoder blocks, query-variant fans and compression
    # blocks compete for the same retrieval pool under distinct SLO tiers
    "heterogeneous": MixSpec(
        "heterogeneous",
        weights={"one-shot": 2.0, "hyde": 1.0, "multistep": 1.0,
                 "irg": 1.0, "recomp": 1.0, "rerank": 2.0,
                 "multiquery": 2.0, "hybrid": 2.0, "compress": 1.0,
                 "pipeline": 1.0},
        slo_tiers_us={"one-shot": 2.5e6, "hyde": 4e6, "recomp": 6e6,
                      "multistep": 10e6, "irg": 10e6, "rerank": 4e6,
                      "multiquery": 5e6, "hybrid": 3e6, "compress": 6e6,
                      "pipeline": 12e6}),
}
