"""starcoder2-7b [dense] — GQA, RoPE, sliding-window attention (4096).

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
[arXiv:2402.19173; hf]
"""

from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab_size=49152, head_dim=128,
    mlp_type="gelu", use_rope=True, rope_theta=1e5,
    sliding_window=4096,
)


def smoke_config():
    return reduced(CONFIG, n_kv_heads=2)
