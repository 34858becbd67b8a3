"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
[arXiv:2401.04088; hf]
"""

from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128,
    mlp_type="swiglu", use_rope=True, rope_theta=1e6,
    sliding_window=4096,
    moe_experts=8, moe_top_k=2, moe_every=1,
)


def smoke_config():
    return reduced(CONFIG)
