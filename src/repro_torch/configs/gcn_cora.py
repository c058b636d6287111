"""GCN (Kipf & Welling) Cora configuration: 2 layers, d=16, mean/symmetric
normalization. [arXiv:1609.02907; paper]"""

from repro_torch.configs.base import GNNConfig

FAMILY = "gnn"
SOURCE = "arXiv:1609.02907; paper"

CONFIG = GNNConfig(
    name="gcn-cora", kind="gcn",
    n_layers=2, d_hidden=16, aggregator="mean", norm="sym", d_out=7,
)

REDUCED = GNNConfig(
    name="gcn-reduced", kind="gcn",
    n_layers=2, d_hidden=8, aggregator="mean", norm="sym", d_out=3,
)
