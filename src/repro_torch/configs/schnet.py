"""SchNet: continuous-filter convolutions over interatomic distances,
3 interaction blocks, d=64, 300 RBFs, 10A cutoff. [arXiv:1706.08566; paper]"""

from repro_torch.configs.base import GNNConfig

FAMILY = "gnn"
SOURCE = "arXiv:1706.08566; paper"

CONFIG = GNNConfig(
    name="schnet", kind="schnet",
    n_layers=3, d_hidden=64, aggregator="sum",
    rbf=300, cutoff=10.0, d_out=1,
)

REDUCED = GNNConfig(
    name="schnet-reduced", kind="schnet",
    n_layers=2, d_hidden=16, aggregator="sum",
    rbf=16, cutoff=5.0, d_out=1,
)
