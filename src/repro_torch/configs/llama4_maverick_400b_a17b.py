"""Llama-4 Maverick 400B-A17B: 128-expert top-1 MoE interleaved with dense
layers, one shared expert (early-fusion backbone; frontend stubbed).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.configs.base import LayerSpec, MoEConfig, TransformerConfig

FAMILY = "lm"
SOURCE = "hf:meta-llama/Llama-4-Scout-17B-16E; unverified"

CONFIG = TransformerConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    # Maverick alternates dense-FFN and MoE layers (interleave_moe=2)
    pattern=(LayerSpec(moe=False), LayerSpec(moe=True)),
    moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, shared_experts=1),
    rope_theta=500_000.0,
)

REDUCED = TransformerConfig(
    name="llama4-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    pattern=(LayerSpec(moe=False), LayerSpec(moe=True)),
    moe=MoEConfig(n_experts=8, top_k=1, d_ff=64, shared_experts=1),
    dtype="float32",
)
