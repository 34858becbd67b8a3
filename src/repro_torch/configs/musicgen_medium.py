"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.  The EnCodec
frontend is a STUB: ``input_specs`` provides 256 precomputed frame
embeddings prepended to the token sequence (DESIGN §6).
[arXiv:2306.05284; hf]
"""

from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, head_dim=64,
    mlp_type="gelu", use_rope=False,   # sinusoidal in paper; stub w/o pos
    frontend_tokens=256,
)


def smoke_config():
    return reduced(CONFIG, n_kv_heads=4)
