"""Qwen1.5-110B: dense GQA with QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.configs.base import TransformerConfig

FAMILY = "lm"
SOURCE = "hf:Qwen/Qwen1.5-0.5B; hf"

CONFIG = TransformerConfig(
    name="qwen1.5-110b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0,
)

REDUCED = TransformerConfig(
    name="qwen-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, qkv_bias=True, dtype="float32",
)
