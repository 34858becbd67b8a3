"""llava-next-34b [vlm] — Yi-34B-class backbone, anyres patch tiling.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The vision tower
is a STUB: ``input_specs`` provides 2880 precomputed anyres patch
embeddings (5 tiles × 576) prepended to the token stream (DESIGN §6).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, head_dim=128,
    mlp_type="swiglu", use_rope=True, rope_theta=5e6,
    frontend_tokens=2880,
)


def smoke_config():
    return reduced(CONFIG)
