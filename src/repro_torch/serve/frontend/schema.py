"""JSON wire contract of the traversal front-end (``/v1/traverse``) — the
port of ``repro.serve.frontend.schema``, the same contract.

One request is one batched traversal: a graph name plus 1..S distinct
source vertex ids (S = the lane's largest bucket).  The response carries
the per-source depth rows of the engine's distance matrix — raw int32
values including the ``INF`` unreached sentinel, so a client comparison
against an in-process ``BFSEngine.run`` is *bitwise*, never epsilon —
and, on request, a parent vector derived host-side from the depths.

Validation here is typed (``RequestError`` carries an HTTP status) so
the transport maps malformed input to 400s at the door; semantic source
validation (range, duplicates) happens in
``BFSService.traverse_async`` -> ``validate_sources`` and is mapped by
the server to the same 400 family.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from repro_torch.core.frontier import INF

#: wire value of an unreached vertex (int32 ``2**30`` on the device);
#: echoed in every response so clients need not hard-code it
UNREACHED = int(INF)

#: hard cap on request body size (a traverse request is a name + a small
#: id list; anything near this is malformed or hostile)
MAX_BODY_BYTES = 1 << 20

#: hard cap on sources per request, independent of any lane's ladder —
#: bounds the work a single malformed request can queue
MAX_SOURCES_PER_REQUEST = 4096


class RequestError(ValueError):
    """Malformed request; ``status`` is the HTTP code the transport
    should answer with (400 unless stated otherwise)."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


def parse_traverse_request(body: bytes) -> dict:
    """Decode + structurally validate a ``/v1/traverse`` body.

    Returns ``{"graph": str|None, "sources": [int, ...],
    "include_parents": bool, "deadline_ms": float|None}``.
    Range/duplicate checks are deferred to the service's submit-time
    ``validate_sources`` (they need the lane's vertex count); everything
    shape- and type-level fails here.
    """
    if len(body) > MAX_BODY_BYTES:
        raise RequestError(f"request body of {len(body)} bytes exceeds "
                           f"the {MAX_BODY_BYTES}-byte limit", status=413)
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise RequestError(f"request body is not valid JSON: {exc}")
    if not isinstance(obj, dict):
        raise RequestError("request body must be a JSON object with a "
                           "'sources' list (and optionally 'graph')")
    unknown = sorted(set(obj) - {"graph", "sources", "include_parents",
                                 "deadline_ms"})
    if unknown:
        raise RequestError(f"unknown request field(s) {unknown}; expected "
                           "graph, sources, include_parents, deadline_ms")

    graph = obj.get("graph")
    if graph is not None and not isinstance(graph, str):
        raise RequestError(f"'graph' must be a string lane name, got "
                           f"{type(graph).__name__}")

    sources = obj.get("sources")
    if not isinstance(sources, list) or not sources:
        raise RequestError("'sources' must be a non-empty list of vertex "
                           "ids")
    if len(sources) > MAX_SOURCES_PER_REQUEST:
        raise RequestError(f"{len(sources)} sources exceed the per-request "
                           f"limit of {MAX_SOURCES_PER_REQUEST}")
    for s in sources:
        # bool is an int subclass; reject it explicitly
        if isinstance(s, bool) or not isinstance(s, int):
            raise RequestError(f"source ids must be integers, got {s!r}")

    include_parents = obj.get("include_parents", False)
    if not isinstance(include_parents, bool):
        raise RequestError("'include_parents' must be a boolean")

    # request deadline: a *budget* in ms from admission, propagated
    # admission -> queue -> dispatch so expired work is reaped (504)
    # before it reaches the device
    deadline_ms = obj.get("deadline_ms")
    if deadline_ms is not None:
        if isinstance(deadline_ms, bool) or \
                not isinstance(deadline_ms, (int, float)):
            raise RequestError("'deadline_ms' must be a number of "
                               "milliseconds")
        if not deadline_ms > 0:
            raise RequestError(f"'deadline_ms' must be positive "
                               f"({deadline_ms})")
        deadline_ms = float(deadline_ms)
    return {"graph": graph, "sources": [int(s) for s in sources],
            "include_parents": include_parents, "deadline_ms": deadline_ms}


def derive_parents(src: np.ndarray, dst: np.ndarray,
                   depths: np.ndarray) -> np.ndarray:
    """A valid BFS parent matrix from the edge list + depth matrix.

    ``depths`` is the (n, S) distance matrix; the result is (n, S) int64
    with ``parents[v] = u`` for some arc ``u -> v`` on a shortest path
    (the smallest such ``u`` — deterministic), ``parents[source] =
    source`` and ``-1`` for unreached vertices.  Host-side O(E·S): the
    engine ships depths only, so parents are a front-end derivation, not
    a device output.
    """
    depths = np.asarray(depths)
    if depths.ndim == 1:
        depths = depths[:, None]
    n, s = depths.shape
    parents = np.full((n, s), -1, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    for j in range(s):
        d = depths[:, j]
        on_path = (d[src] + 1 == d[dst]) & (d[src] < UNREACHED)
        col = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(col, dst[on_path], src[on_path])
        found = col != np.iinfo(np.int64).max
        parents[found, j] = col[found]
        parents[d == 0, j] = np.where(d == 0)[0]   # each source roots itself
    return parents


def derive_parents_on_device(src: torch.Tensor, dst: torch.Tensor,
                             depths: torch.Tensor) -> torch.Tensor:
    """``derive_parents`` on the device that holds ``depths`` (``(n, S)``
    int32) and the int64 edge list ``src`` / ``dst``: the same parents
    (the smallest ``u`` of an on-path arc), one scatter-min a column, so
    a front end on a card prices parents in milliseconds where the host
    rule costs a second a column of a million-vertex graph."""
    n, s = depths.shape
    dev = depths.device
    none = torch.iinfo(torch.int64).max
    parents = torch.full((n, s), -1, dtype=torch.int64, device=dev)
    ids = torch.arange(n, device=dev)
    for j in range(s):
        d = depths[:, j].long()
        ds = d[src]
        on_path = (ds + 1 == d[dst]) & (ds < UNREACHED)
        col = torch.full((n,), none, dtype=torch.int64, device=dev)
        col.scatter_reduce_(0, dst[on_path], src[on_path], "amin")
        parents[:, j] = torch.where(col != none, col, -1)
        root = d == 0                           # each source roots itself
        parents[root, j] = ids[root]
    return parents


#: every id or depth below this, and ``UNREACHED``, has its text in one
#: lookup table (``_int_table``): a response's rows are one gather, not a
#: Python int a vertex
_TABLE_TOP = 1 << 21
_FIELD = 13                     # 11 columns, right-aligned, then ", "
_TABLE = None


def _int_table() -> np.ndarray:
    """``(_TABLE_TOP + 2, _FIELD)`` uint8: row ``v + 1`` holds ``v`` for
    ``-1 <= v < _TABLE_TOP`` and the last row ``UNREACHED``, each
    right-aligned in 11 columns (the first always a space) and followed
    by ``", "`` (built once)."""
    global _TABLE
    if _TABLE is None:
        vals = np.append(np.arange(-1, _TABLE_TOP), UNREACHED)
        table = np.full((vals.size, _FIELD), ord(" "), np.uint8)
        table[:, -2:] = np.frombuffer(b", ", np.uint8)
        a, place = np.abs(vals), 1
        for col in range(_FIELD - 3, -1, -1):
            table[:, col] = np.where((a >= place) | (place == 1),
                                     ord("0") + (a // place) % 10, ord(" "))
            place *= 10
        table[0, _FIELD - 4] = ord("-")          # -1
        _TABLE = table
    return _TABLE


def json_int_rows(m) -> bytes:
    """JSON text of a 2-D integer array as a list of rows; it parses to
    ``m.tolist()``.  Where every value lies in ``[-1, 2**21)`` or equals
    ``UNREACHED`` (the depths and parents of graphs of up to 2**21
    vertices) the text is one gather from ``_int_table`` — each number
    right-aligned in 11 columns, which JSON allows — so a million-vertex
    row costs milliseconds, not the Python int a vertex of
    ``json.dumps``; any other array is ``json.dumps``."""
    m = np.asarray(m)
    if m.ndim != 2 or 0 in m.shape or not np.issubdtype(m.dtype,
                                                        np.integer):
        return json.dumps(m.tolist()).encode()
    v = np.ascontiguousarray(m)
    unreached = v == UNREACHED
    if not np.all(unreached | ((v >= -1) & (v < _TABLE_TOP))):
        return json.dumps(m.tolist()).encode()
    code = np.where(unreached, _TABLE_TOP + 1, v + 1)
    out = np.empty(1 + v.size * _FIELD, np.uint8)
    out[0] = ord("[")
    table = _int_table()
    # one _FIELD-byte item a number: a void gather copies it whole
    np.take(table.view(f"V{_FIELD}")[:, 0], code, mode="clip",
            out=out[1:].view(f"V{_FIELD}").reshape(v.shape))
    text = out[1:].reshape(*v.shape, _FIELD)
    text[:, 0, 0] = ord("[")                     # over a leading space
    text[:, -1, -2:] = np.frombuffer(b"],", np.uint8)
    text[-1, -1, -1] = ord("]")
    return out.tobytes()


def encode_traverse_response(*, graph: str, sources, bucket: int,
                             depths: np.ndarray,
                             parents: Optional[np.ndarray],
                             run_stats: dict, timing_ms: dict) -> bytes:
    """Serialize one traversal result; ``depths`` is the engine's
    padding-stripped ``dist_host`` (n_logical, len(sources)).

    The JSON value is the JAX package's, key order included; the depth
    and parent rows are written by ``json_int_rows``.
    """
    depths = np.asarray(depths)
    head = json.dumps({
        "graph": graph,
        "sources": [int(s) for s in sources],
        "bucket": int(bucket),
        "n": int(depths.shape[0]),
        "unreached": UNREACHED,
    }).encode("utf-8")
    # row per source (column-major transpose of dist_host): the natural
    # client shape, and json encodes int32 exactly
    parts = [head[:-1], b', "depths": ', json_int_rows(depths.T),
             b', "stats": ', json.dumps(run_stats).encode("utf-8"),
             b', "timing_ms": ', json.dumps(
                 {k: round(float(v), 3)
                  for k, v in timing_ms.items()}).encode("utf-8")]
    if parents is not None:
        parts += [b', "parents": ', json_int_rows(np.asarray(parents).T)]
    return b"".join(parts) + b"}"
