"""Gemma-3 12B: dense, 5:1 local:global attention (1024-token sliding
window on local layers), 128k context. [hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.configs.base import LayerSpec, TransformerConfig

FAMILY = "lm"
SOURCE = "hf:google/gemma-3-1b-pt; unverified"

_LOCAL = LayerSpec(window=1024)
_GLOBAL = LayerSpec(window=0)

CONFIG = TransformerConfig(
    name="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    rope_theta=1_000_000.0,
)

REDUCED = TransformerConfig(
    name="gemma3-reduced",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    pattern=(LayerSpec(window=16), LayerSpec(window=16), LayerSpec(window=16),
             LayerSpec(window=16), LayerSpec(window=16), LayerSpec(window=0)),
    dtype="float32",
)
