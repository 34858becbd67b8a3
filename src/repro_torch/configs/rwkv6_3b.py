"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536, head size 64 (40 heads).
[arXiv:2404.05892; hf]
"""

from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab_size=65536, head_dim=64,
    mixer="rwkv", rwkv_head_size=64, use_rope=False,
    time_chunk=32,
)


def smoke_config():
    return reduced(CONFIG, d_model=128, rwkv_head_size=32)
