"""Configurations — the port's copy of ``repro.configs.base``: the BFS
workloads (the paper's own experiments, §4, plus the Graph500 Kronecker
graph) and the LM, GNN and RecSys families' dataclasses and shape cells.

Every architecture is a module ``repro_torch/configs/<id>.py`` exposing
``CONFIG`` (the exact published configuration), ``REDUCED`` (a tiny
same-family config for CPU tests), ``FAMILY`` and ``SOURCE``, each the JAX
package's field for field.  ``registry()`` maps arch id -> ``ArchSpec``;
``all_cells()`` yields the 40 (arch, shape) cells."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional, Sequence


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    capacity_factor: float = 1.25
    shared_experts: int = 0        # dense experts always active (Llama-4)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating layer pattern."""
    window: int = 0                # 0 = global attention; >0 = sliding window
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # attention impl knobs of the JAX package, kept so configs copy verbatim
    attn_chunk: int = 1024
    remat: str = "block"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers % pattern period != 0")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * dh
        dense_ffn = 3 * d * self.d_ff
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            spec = self.pattern[i % len(self.pattern)]
            total += attn + 2 * d
            if spec.moe and self.moe:
                m = self.moe
                total += d * m.n_experts                   # router
                total += m.n_experts * 3 * d * m.d_ff      # routed experts
                total += m.shared_experts * 3 * d * m.d_ff
            else:
                total += dense_ffn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        for i in range(self.n_layers):
            if self.pattern[i % len(self.pattern)].moe:
                total -= (m.n_experts - m.top_k) * 3 * d * m.d_ff
        return total


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    step: str            # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES = (
    LMShape("train_4k", "train", 4_096, 256),
    LMShape("prefill_32k", "prefill", 32_768, 32),
    LMShape("decode_32k", "decode", 32_768, 128),
    LMShape("long_500k", "decode", 524_288, 1),
)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                      # gcn | gatedgcn | schnet | graphcast
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"        # sum | mean | gated
    d_out: int = 1
    # family extras
    rbf: int = 0                   # schnet radial basis size
    cutoff: float = 0.0            # schnet distance cutoff
    n_vars: int = 0                # graphcast output variables
    mesh_refinement: int = 0       # graphcast native icosahedral refinement
    norm: str = "none"             # gcn-cora: sym normalization
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    mode: str                      # full | sampled | batched
    n_nodes: int
    n_edges: int
    d_feat: int
    batch_nodes: int = 0           # sampled mode: seed nodes per step
    fanout: tuple = ()             # sampled mode: per-hop fanout
    batch_graphs: int = 0          # batched mode: graphs per batch


GNN_SHAPES = (
    GNNShape("full_graph_sm", "full", 2_708, 10_556, 1_433),
    # Reddit-scale sampled training; d_feat=602 (Reddit's feature width —
    # the cell spec gives counts only).  The step input is the sampled
    # subgraph: 1024 seeds, fanout 15 then 10.
    GNNShape("minibatch_lg", "sampled", 232_965, 114_615_892, 602,
             batch_nodes=1_024, fanout=(15, 10)),
    GNNShape("ogb_products", "full", 2_449_029, 61_859_140, 100),
    GNNShape("molecule", "batched", 30, 64, 32, batch_graphs=128),
)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int                  # categorical fields
    n_dense: int                   # dense features (Criteo: 13)
    embed_dim: int
    vocab_per_field: int           # rows per field table
    mlp_dims: tuple
    interaction: str = "fm"
    dtype: str = "float32"

    @property
    def total_rows(self) -> int:
        return self.n_sparse * self.vocab_per_field


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    step: str                      # train | serve | retrieval
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = (
    RecsysShape("train_batch", "train", 65_536),
    RecsysShape("serve_p99", "serve", 512),
    RecsysShape("serve_bulk", "serve", 262_144),
    RecsysShape("retrieval_cand", "retrieval", 1, n_candidates=1_000_000),
)


# ---------------------------------------------------------------------------
# BFS workloads (the paper's own experiments, §4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BFSWorkload:
    name: str
    graph: str                     # generators.GENERATORS key
    n_vertices: int
    gen_kwargs: tuple = ()         # sorted (k, v) pairs
    n_sources: int = 1


BFS_WORKLOADS = (
    BFSWorkload("star_4m", "star", 4_000_000),
    BFSWorkload("erdos_renyi_100k", "erdos_renyi", 100_000,
                (("avg_degree", 16.0),)),
    BFSWorkload("small_world_100k", "small_world", 100_000,
                (("beta", 0.1), ("k", 16))),
    BFSWorkload("rmat_1m", "rmat", 1_048_576, (("edge_factor", 16),)),
)


def bfs_workload(name: str) -> BFSWorkload:
    """Look a workload up by name."""
    for w in BFS_WORKLOADS:
        if w.name == name:
            return w
    raise KeyError(f"unknown BFS workload {name!r}; have "
                   f"{[w.name for w in BFS_WORKLOADS]}")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys
    config: Any
    reduced: Any
    source: str                    # provenance note of the configuration

    @property
    def shapes(self) -> Sequence:
        return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                "recsys": RECSYS_SHAPES}[self.family]


ARCH_IDS = (
    "dbrx_132b", "llama4_maverick_400b_a17b", "gemma3_12b", "yi_34b",
    "qwen1_5_110b",
    "graphcast", "gatedgcn", "schnet", "gcn_cora",
    "deepfm",
)


def _spec(arch_id: str) -> ArchSpec:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return ArchSpec(arch_id=arch_id, family=mod.FAMILY, config=mod.CONFIG,
                    reduced=mod.REDUCED, source=mod.SOURCE)


def registry() -> dict:
    """``{arch_id: ArchSpec}`` of every architecture, in ``ARCH_IDS``'
    order."""
    return {arch_id: _spec(arch_id) for arch_id in ARCH_IDS}


def get_arch(arch_id: str) -> ArchSpec:
    """The spec of ``arch_id`` (one of ``ARCH_IDS``, ``-`` or ``_``
    alike: ``gemma3-12b``); ``KeyError`` naming the architectures for any
    other."""
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; have "
                       f"{list(ARCH_IDS)}")
    return _spec(arch_id)


def get_shape(spec: ArchSpec, shape_name: str):
    for sh in spec.shapes:
        if sh.name == shape_name:
            return sh
    raise KeyError(f"{spec.arch_id} has no shape {shape_name!r}; "
                   f"have {[s.name for s in spec.shapes]}")


def all_cells():
    """All 40 (ArchSpec, shape) cells, arch by arch in ``ARCH_IDS``'
    order."""
    for arch_id in ARCH_IDS:
        spec = get_arch(arch_id)
        for sh in spec.shapes:
            yield spec, sh
