"""granite-3-8b [dense] — GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155 (padded →49408).
[hf:ibm-granite/granite-3.0-2b-base; hf]
"""

from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
    vocab_size=49155, head_dim=128,
    mlp_type="swiglu", use_rope=True, rope_theta=1e4,
)


def smoke_config():
    return reduced(CONFIG)
