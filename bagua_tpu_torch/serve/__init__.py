"""Serving plane: continuous-batching inference over trained artifacts.

Port of ``bagua_tpu/serve/``:

* :mod:`~bagua_tpu_torch.serve.cache` — the paged KV-cache's host
  bookkeeping: the page-pool allocator and the per-slot block tables over
  the per-layer page pools of the transformer's paged decode
  (``TransformerConfig(decode=True, page_size=…, num_pages=…)``).
* :mod:`~bagua_tpu_torch.serve.engine` — the continuous-batching scheduler:
  join-mid-batch / evict-on-finish, chunked prefill that never stalls
  running decodes, queue-then-preempt backpressure on pool exhaustion.
* :mod:`~bagua_tpu_torch.serve.loader` — integrity-verified weight loads
  through the checkpoint digest chain, with the layout sidecar's
  flat-to-serving conversion.
* :mod:`~bagua_tpu_torch.serve.schema` — the serving bench's record schema
  (``bagua-bench-serve-v1``) and its validator.

Observability rides the existing planes:
``serve/*`` spans and counters, and the goodput ledger's serving classes.
"""

from .cache import PagePool, SlotTable  # noqa: F401
from .engine import (  # noqa: F401
    Request,
    ServeConfig,
    ServeEngine,
    ServeQueueFull,
)
from .loader import load_serving_params, save_serving_artifact  # noqa: F401
from .schema import (  # noqa: F401
    SERVE_BENCH_SCHEMA,
    SERVE_SPEEDUP_GATE,
    validate_serve_bench,
)
