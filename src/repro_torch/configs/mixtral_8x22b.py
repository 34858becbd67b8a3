"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
[arXiv:2401.04088; hf]
"""

from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768, head_dim=128,
    mlp_type="swiglu", use_rope=True, rope_theta=1e6,
    sliding_window=4096,
    moe_experts=8, moe_top_k=2, moe_every=1,
    train_microbatches=16,      # 56L giant: halve live activations again
)


def smoke_config():
    return reduced(CONFIG, train_microbatches=0)
