"""DBRX-132B: 16-expert fine-grained MoE, top-4 routing, GQA.
[hf:databricks/dbrx-base; unverified]"""

from repro_torch.configs.base import LayerSpec, MoEConfig, TransformerConfig

FAMILY = "lm"
SOURCE = "hf:databricks/dbrx-base; unverified"

CONFIG = TransformerConfig(
    name="dbrx-132b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    pattern=(LayerSpec(moe=True),),
    moe=MoEConfig(n_experts=16, top_k=4, d_ff=10752),
)

REDUCED = TransformerConfig(
    name="dbrx-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256,
    pattern=(LayerSpec(moe=True),),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff=96),
    dtype="float32",
)
