"""Sum-mode EmbeddingBag (A5) — wrapper of the hand-written CUDA kernels in
``csrc/embedding_bag_kernels.cu``, the port of
``repro.kernels.embedding_bag.kernel``.

On a CUDA tensor ``embedding_bag_sum`` launches a kernel or raises; on a
CPU tensor it runs the plain version, ``embedding_bag_sum_plain``.  Both
sum each bag's rows in f32 in slot order and skip the pads, then cast to
the table's dtype: on a finite table that is bitwise the Pallas kernel's
sum (which multiplies a pad's row 0 by 0, and so gives NaN over a
non-finite row 0 where these give the oracle's value).  An index >= V
raises in both (``ref.check_indices``: one reduction over the indices and
a host read), before ``_launch`` starts the kernel.

Two routes, chosen by ``bag_geometry`` from the shape and the table's
size and alignment, never by a failure: ``emb_bag_gather``
(``bag_gather_kernel``, the asynchronous row gather staged through shared
memory) for narrow rows that a 4-, 8- or 16-byte granule divides, where
``route_bench`` timed it faster; ``emb_bag_sum`` (``bag_sum_kernel``,
plain loads) for the rest: wider rows, 20- to 40-byte rows of a table the
L2 holds, and bf16 rows of odd D.  ``embedding_bag_sum.launches`` counts
both, ``launches_gather`` and ``launches_loads`` each route.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import check_indices

INT_MAX = 2 ** 31 - 1                # grid.x; L and D are ints in the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# bag_gather_kernel's tiling (csrc/embedding_bag_kernels.cu)
STAGES = 3                           # the ring's depth, 2 .. 8
BAR_BYTES = 64                       # its mbarriers (kBarBytes)
STAGE_BYTES = 32 * 1024              # rows + indices a stage aims to hold
MAX_ROW_BYTES = 8 * 1024             # wider rows take the plain-load route
CTAS_PER_SM = 2
SMEM_BLOCK = 232_448                 # 227 KB: a CTA's dynamic shared memory
SMEM_SM = 233_472                    # 228 KB an SM, 1 KB of it a CTA's own
GRANULES = (16, 8, 4)                # cp.async sizes, widest first
# the route rule (bag_geometry), from route_bench.py's timings on an H100:
# the gather is the faster route for rows of at most SMALL_ROW_BYTES on any
# table, and for rows of at most GATHER_ROW_BYTES on a table larger than
# L2_TABLE_BYTES (whose rows the 50 MB L2 does not hold); plain loads for
# the rest
SMALL_ROW_BYTES = 16
GATHER_ROW_BYTES = 40
L2_TABLE_BYTES = 48 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class BagGeometry:
    """The launch of A5 at one shape.  ``route`` is "gather" or "loads"
    (``bag_sum_kernel`` sets its own grid; the other fields are 0).
    Gather: a tile is ``bags`` consecutive bags, cut into ``chunks`` chunks
    of ``slots`` slots (one chunk unless ``bags`` is 1); ``grid`` CTAs walk
    the ``tiles`` tiles in turn; each of the ``stages`` stages holds
    ``idx_words`` int32 and ``row_stage_bytes`` of rows, ``acc_bytes`` of
    f32 partial sums carry a bag across chunks; ``granule`` is the bytes of
    one ``cp.async``."""
    route: str
    granule: int = 0
    stages: int = 0
    bags: int = 0
    slots: int = 0
    chunks: int = 0
    tiles: int = 0
    grid: int = 0
    idx_words: int = 0
    row_stage_bytes: int = 0
    acc_bytes: int = 0
    smem_bytes: int = 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def gather_geometry(b: int, l: int, d: int, itemsize: int, sms: int = 132,
                    align: int = 16) -> BagGeometry:
    """``bag_gather_kernel``'s launch for B, L, D >= 1 over rows of
    ``itemsize``-byte elements, on ``sms`` SMs, with the table's address a
    multiple of ``align`` bytes (a power of two); route "loads" where no
    granule divides the row or it is wider than ``MAX_ROW_BYTES``."""
    row = d * itemsize
    granule = next((g for g in GRANULES if row % g == 0 and align % g == 0),
                   0)
    if not granule or row > MAX_ROW_BYTES:
        return BagGeometry("loads")
    cap = STAGE_BYTES // (row + 4)       # slots a stage holds, >= 1
    if l <= cap:
        chunks, slots, bags = 1, l, cap // l
    else:                                # one bag a tile, in even chunks
        chunks = _ceil(l, cap)
        slots, bags = _ceil(l, chunks), 1
    ctas = CTAS_PER_SM * sms
    bags = max(1, min(bags, _ceil(b, ctas)))   # a tile for every CTA
    tiles = _ceil(b, bags)
    idx_words = _ceil(bags * slots + 4, 4) * 4     # + the unaligned head
    row_stage = _ceil(bags * slots * row, 16) * 16
    acc = d * 4 if chunks > 1 else 0
    smem = BAR_BYTES + STAGES * (idx_words * 4 + row_stage) + acc
    return BagGeometry("gather", granule, STAGES, bags, slots, chunks, tiles,
                       min(tiles, ctas), idx_words, row_stage, acc, smem)


def bag_geometry(b: int, l: int, v: int, d: int, itemsize: int,
                 sms: int = 132, align: int = 16) -> BagGeometry:
    """A5's launch for a (B, L) index over a (V, D) table: the gather
    (``gather_geometry``) for rows of at most ``SMALL_ROW_BYTES``, or of at
    most ``GATHER_ROW_BYTES`` on a table of more than ``L2_TABLE_BYTES``;
    else the plain-load route."""
    row = d * itemsize
    if row > GATHER_ROW_BYTES or (row > SMALL_ROW_BYTES
                                  and v * row <= L2_TABLE_BYTES):
        return BagGeometry("loads")
    return gather_geometry(b, l, d, itemsize, sms, align)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def embedding_bag_sum_plain(indices: torch.Tensor,
                            table: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch: an f32 sum over the L slots in
    order, a pad slot adding nothing, then a cast."""
    check_indices(indices, table)
    acc = torch.zeros((indices.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for l in range(indices.shape[1]):
        idx = indices[:, l]
        valid = idx >= 0
        acc[valid] += table[idx[valid]].float()
    return acc.to(table.dtype)


def _launch(indices: torch.Tensor, table: torch.Tensor, out: torch.Tensor,
            route: str | None = None) -> BagGeometry:
    """Launch A5 into ``out`` (B, D) for checked, contiguous CUDA operands
    with B, L, D >= 1, by the route ``bag_geometry`` gives, or by ``route``
    ("gather" or "loads", to time one route beside the other; the gather
    raises ``ValueError`` on rows ``gather_geometry`` does not take);
    returns the geometry."""
    b, l = indices.shape
    v, d = table.shape
    dev = out.device
    ptr = table.data_ptr()
    shape = (b, l, d, table.element_size(), _sm_count(dev.index), ptr & -ptr)
    if route is None:
        geo = bag_geometry(b, l, v, *shape[2:])
    elif route == "gather":
        geo = gather_geometry(*shape)
        if geo.route != "gather":
            raise ValueError(f"the gather takes no rows of {d} x "
                             f"{table.dtype} at this address")
    elif route == "loads":
        geo = BagGeometry("loads")
    else:
        raise ValueError(f"route is None, 'gather' or 'loads', not {route!r}")
    args = (indices.data_ptr(), ptr, out.data_ptr(), b, l, d,
            _DTYPES[table.dtype])
    if geo.route == "gather":
        _build.launch("emb_bag_gather", dev, *args, geo.granule, geo.stages,
                      geo.bags, geo.slots, geo.chunks, geo.idx_words,
                      geo.row_stage_bytes, geo.smem_bytes, geo.grid)
        embedding_bag_sum.launches_gather += 1
    else:
        _build.launch("emb_bag_sum", dev, *args)
        embedding_bag_sum.launches_loads += 1
    embedding_bag_sum.launches += 1
    return geo


def embedding_bag_sum(indices: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """indices: (B, L) int32, any negative index a pad; table: (V, D) f32
    or bf16 (another dtype raises on either device).  Returns (B, D) in the
    table's dtype (f32 accumulation); an empty bag gives zeros."""
    if table.dtype not in _DTYPES:
        raise ValueError(f"embedding_bag_sum takes an f32 or bf16 table, "
                         f"not {table.dtype}")
    if max((*indices.shape, *table.shape[1:]), default=0) > INT_MAX:
        raise ValueError(f"embedding_bag_sum takes B, L, D <= {INT_MAX}")
    if table.device.type == "cpu":
        return embedding_bag_sum_plain(indices, table)
    check_indices(indices, table)
    dev = _build.require_cuda("embedding_bag_sum", indices, table)
    b, l = indices.shape
    out = torch.empty((b, table.shape[1]), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    if l == 0:
        return out.zero_()
    _launch(indices, table, out)
    return out


embedding_bag_sum.launches = 0
embedding_bag_sum.launches_gather = 0
embedding_bag_sum.launches_loads = 0
