"""stablelm-1.6b [dense] — MHA (kv=32).

24L d_model=2048 32H d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""

from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100352, head_dim=64,
    mlp_type="swiglu", use_rope=True, rope_theta=1e4,
)


def smoke_config():
    return reduced(CONFIG, n_kv_heads=4)
