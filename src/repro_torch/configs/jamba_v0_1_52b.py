"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts
top-2 every other layer; attention every 8th layer, no RoPE.
[arXiv:2403.19887; hf]
"""

from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128,
    mlp_type="swiglu", use_rope=False,
    mixer="mamba", attn_every=8,
    moe_experts=16, moe_top_k=2, moe_every=2,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)


def smoke_config():
    return reduced(CONFIG, n_layers=8, moe_experts=4)
