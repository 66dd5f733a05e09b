"""Serving on the port: the batched `ServeEngine` of its language models,
and the query tier over the streaming `RankServer` (the JAX package's
serving/, with the same names):

  * `QueryBatcher`  — fuses concurrent `personalized()` calls into the
                      (n, nv) lane solve `ppr_push_batched` on a device;
  * `QueryRouter` / `ReadReplica` — N snapshot holders behind
                      staleness-bounded reads with atomic publish fan-out;
  * `PPRCache`      — (seed set, version)-keyed result cache with
                      certified-staleness invalidation (host numpy).

`attach_query_tier(server)` wires all three.
"""
from ..device import DeviceLike
from .batcher import QueryBatcher
from .engine import ServeEngine
from .ppr_cache import CacheHitStats, PPRCache
from .router import QueryRouter, ReadReplica, StalenessBoundExceeded

__all__ = [
    "ServeEngine",
    "QueryBatcher", "PPRCache", "CacheHitStats",
    "QueryRouter", "ReadReplica", "StalenessBoundExceeded",
    "attach_query_tier",
]


def attach_query_tier(server, *, max_batch: int = 16,
                      max_delay_s: float = 0.002,
                      cache_capacity: int = 64, replicas: int = 0,
                      max_version_lag: int = 0, on_stale: str = "redirect",
                      backend: str = "auto", device: DeviceLike = None):
    """Wire a full query tier onto a `RankServer`.

    Returns (batcher, cache, router); router is None when replicas == 0.
    The batcher is attached and running, its lane solves on `device`
    (None: the CUDA card, raising without one, before anything is
    attached); stop it with `batcher.stop()`.
    """
    batcher = QueryBatcher(server, max_batch=max_batch,
                           max_delay_s=max_delay_s, backend=backend,
                           device=device)
    cache = PPRCache(alpha=server.alpha, capacity=cache_capacity)
    server._ppr_cache = cache
    batcher.attach()
    router = None
    if replicas > 0:
        router = QueryRouter(server, replicas,
                             max_version_lag=max_version_lag,
                             on_stale=on_stale)
    return batcher, cache, router
