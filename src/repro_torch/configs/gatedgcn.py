"""GatedGCN (Bresson & Laurent): edge-gated message passing, 16 layers,
d=70. [arXiv:2003.00982; paper]"""

from repro_torch.configs.base import GNNConfig

FAMILY = "gnn"
SOURCE = "arXiv:2003.00982; paper"

CONFIG = GNNConfig(
    name="gatedgcn", kind="gatedgcn",
    n_layers=16, d_hidden=70, aggregator="gated", d_out=1,
)

REDUCED = GNNConfig(
    name="gatedgcn-reduced", kind="gatedgcn",
    n_layers=2, d_hidden=16, aggregator="gated", d_out=1,
)
