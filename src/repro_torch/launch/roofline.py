"""The H100 roofline of one BFS level — the port's counterpart of the
TPU constants in ``repro.launch.hlo_stats`` and of ``_roofline_row`` in
``repro.core.engine``.

``describe()["roofline"]`` prices each level kind with ``roofline_row``
from the plan's byte and operation counts (the JAX plan's formulas, so
the counts equal JAX's and only the times differ).  The module is
stdlib-only, so ``core.engine`` imports it without a cycle.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (80 GB HBM3) at its full 700 W power limit, as
# NVIDIA's data sheet states its peaks (dense rates, no sparsity); a card
# set below 700 W runs slower under load, so read a measured time beside
# `nvidia-smi --query-gpu=name,power.limit`.
HBM_BW = 3.35e12              # B/s, HBM3
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, fp32 on the CUDA cores
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, TF32 on the tensor cores
# NVLink 4 of the SXM part: 900 GB/s a card over its 18 links, both
# directions together; a collective's received bytes cross one direction
# (the price of a DistMesh's shards, one a card)
NVLINK_BW = 450e9             # B/s


def roofline_row(wire_bytes, hbm_bytes, flops, overlap: bool,
                 shards: int = 1, link: str = "hbm") -> dict:
    """Price one level variant on the H100 roofline.

    Three analytic terms a level, as the JAX row has, from one shard's
    counts: the collective's received bytes, priced as HBM traffic on
    ``link="hbm"`` (a ``LocalMesh`` collective is a permute or broadcast
    on the one card, so each received byte is read once and written once)
    or over NVLink on ``link="nvlink"`` (a ``DistMesh``, one shard a card,
    ``shards=1``: each received byte crosses the link once); memory traffic
    over HBM; and the elementwise work (bit tests and compares, one op
    each) over the CUDA cores' fp32 rate: these are not matrix products,
    so the tensor cores' bf16 peak, which the JAX row uses, does not
    apply.  The ``shards`` shards of a ``LocalMesh`` share the card, so
    each term is that many times one shard's.  Fused plans double-buffer
    the frontier generation, so the collective of level L+1 can overlap
    the tail of level L — ``max(collective, compute)``; unfused plans
    serialize the two (``sum``).
    """
    if link not in ("hbm", "nvlink"):
        raise ValueError(f"unknown link {link!r}; expected hbm | nvlink")
    t_coll = shards * (2.0 * wire_bytes / HBM_BW if link == "hbm"
                       else wire_bytes / NVLINK_BW)
    t_comp = shards * (hbm_bytes / HBM_BW + flops / PEAK_FLOPS_FP32)
    t_level = max(t_coll, t_comp) if overlap else t_coll + t_comp
    return {
        "wire_bytes": float(wire_bytes),
        "hbm_bytes": float(hbm_bytes),
        "flops": float(flops),
        "t_collective_s": t_coll,
        "t_compute_s": t_comp,
        "t_level_s": t_level,
        "bottleneck": "collective" if t_coll >= t_comp else "compute",
        "model": "overlap(max)" if overlap else "serial(sum)",
        "link": link,
        "shards": shards,
    }
