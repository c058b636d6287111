"""Remote serving front-end over the multi-tenant ``BFSService`` — the
port of ``repro.serve.frontend``.

The network-facing layer that turns the repo from a library into a
deployable service.  Four pieces, each its own module:

  * ``schema``    — the JSON request/response wire contract of
    ``POST /v1/traverse`` (+ host-side parent derivation), with
    400-style validation errors typed so the transport can map them.
  * ``admission`` — per-lane bounded admission: queue-depth and
    in-flight-byte gates, fast 429-style rejection with a retry-after
    hint, and the draining (503) state for graceful shutdown.
  * ``metrics``   — per-lane counters and latency histograms (queue
    wait, device time, end-to-end) plus per-bucket dispatch counts;
    rendered by ``GET /metrics`` next to the shared ``EngineCache``'s
    hit/evict counters.
  * ``server``    — the transport: a stdlib ``ThreadingHTTPServer``
    whose handler threads validate + admit, and a single dispatcher
    thread that routes admitted requests to batch-size buckets through
    ``BFSService.traverse_async`` (lanes overlap device work exactly
    like ``BFSService.step``).

``serve_http(service, host, port)`` binds it; the JAX package's
``launch/bfs_client`` is a matching stdlib client (the wire schema is the
contract).
"""

from repro_torch.serve.frontend.admission import (AdmissionError, DrainingError,
                                            LaneGate)
from repro_torch.serve.frontend.metrics import (FrontendMetrics, Histogram,
                                          LaneMetrics)
from repro_torch.serve.frontend.schema import (RequestError, derive_parents,
                                         encode_traverse_response,
                                         parse_traverse_request)
from repro_torch.serve.frontend.server import BFSFrontend, serve_http

__all__ = [
    "AdmissionError", "DrainingError", "LaneGate",
    "FrontendMetrics", "Histogram", "LaneMetrics",
    "RequestError", "derive_parents", "encode_traverse_response",
    "parse_traverse_request",
    "BFSFrontend", "serve_http",
]
