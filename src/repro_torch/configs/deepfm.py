"""DeepFM: 39 sparse fields x dim-10 embeddings, FM interaction + 400-400-400
deep MLP. Vocab per field set to 1M rows (Criteo-scale tables; the published
config gives field/dim/MLP only). [arXiv:1703.04247; paper]"""

from repro_torch.configs.base import RecsysConfig

FAMILY = "recsys"
SOURCE = "arXiv:1703.04247; paper"

CONFIG = RecsysConfig(
    name="deepfm",
    n_sparse=39, n_dense=13, embed_dim=10, vocab_per_field=1_000_000,
    mlp_dims=(400, 400, 400),
)

REDUCED = RecsysConfig(
    name="deepfm-reduced",
    n_sparse=6, n_dense=4, embed_dim=8, vocab_per_field=100,
    mlp_dims=(32, 32),
)
