from repro_torch.retrieval.hotcache import AccessTracker, HotClusterCache, plan_memory_split
from repro_torch.retrieval.hybrid import HybridRetrievalEngine, engine_from_memory_budget
from repro_torch.retrieval.ivf import ClusterCostModel, IVFIndex, TopK
from repro_torch.retrieval.plan import (
    BatchTopK,
    PlanBuilder,
    RetrievalPlan,
    plan_from_work,
    plan_search,
)
from repro_torch.retrieval.synthetic import (
    CorpusConfig,
    DuplicateTrafficEmbedder,
    SyntheticEmbedder,
    make_corpus,
)

__all__ = [
    "IVFIndex",
    "TopK",
    "BatchTopK",
    "PlanBuilder",
    "RetrievalPlan",
    "plan_from_work",
    "plan_search",
    "ClusterCostModel",
    "HotClusterCache",
    "AccessTracker",
    "plan_memory_split",
    "HybridRetrievalEngine",
    "engine_from_memory_budget",
    "CorpusConfig",
    "make_corpus",
    "SyntheticEmbedder",
    "DuplicateTrafficEmbedder",
]
