"""Yi-34B: dense llama-architecture GQA. [arXiv:2403.04652; hf]"""

from repro_torch.configs.base import TransformerConfig

FAMILY = "lm"
SOURCE = "arXiv:2403.04652; hf"

CONFIG = TransformerConfig(
    name="yi-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    rope_theta=5_000_000.0,
)

REDUCED = TransformerConfig(
    name="yi-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, dtype="float32",
)
