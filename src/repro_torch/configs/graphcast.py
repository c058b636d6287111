"""GraphCast: encoder-processor-decoder mesh GNN, 16 processor layers,
d=512, sum aggregation, 227 output variables.  mesh_refinement=6 describes
the native icosahedral mesh (40,962 nodes); the assigned shape cells supply
the actual graph per cell. [arXiv:2212.12794; unverified]"""

from repro_torch.configs.base import GNNConfig

FAMILY = "gnn"
SOURCE = "arXiv:2212.12794; unverified"

CONFIG = GNNConfig(
    name="graphcast", kind="graphcast",
    n_layers=16, d_hidden=512, aggregator="sum",
    n_vars=227, mesh_refinement=6, d_out=227,
)

REDUCED = GNNConfig(
    name="graphcast-reduced", kind="graphcast",
    n_layers=2, d_hidden=32, aggregator="sum",
    n_vars=5, mesh_refinement=1, d_out=5,
)
