"""Retrieval: the hot-cluster cache's hits over its lookups in the window
(``HybridRetrievalEngine.stats()``, differenced over the window)."""


def read(ctx):
    hits, misses = ctx.cache_delta
    return 100.0 * hits / (hits + misses) if hits + misses else None
