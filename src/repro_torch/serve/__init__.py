"""BFS serving — the port of ``repro.serve``'s traversal stack.

  * ``engine_cache`` — ``EngineCache`` (an LRU of compiled engines keyed
    by ``BFSPlan.plan_key()``, priced by ``estimated_device_bytes()``)
    and ``GraphCatalog``.
  * ``batcher`` — ``SlotPool``, the slot scheduler of the lanes.
  * ``bfs_service`` — ``BFSService``: lanes of named graphs, each with
    a ladder of batch-size buckets, resolved through one cache.
  * ``frontend`` — the HTTP front end (``serve_http``).
  * ``resilience`` — faults, deadlines, retries, breakers, the watchdog
    and the degradation arms.

Nothing is imported here: ``core.engine`` reaches the stdlib-only
``resilience.faults``, and this package must not pull the service (and
with it the engine) back in while the engine is loading.
"""
