"""Model/config schema shared by all assigned architectures.

Every architecture file in this package defines ``CONFIG`` (the exact
published configuration) and ``smoke_config()`` (a reduced same-family
variant for CPU tests).  Shapes (``SHAPES``) are global.  A copy of the
JAX package's ``configs/base.py``; the one change is ``torch_dtype`` in
place of ``jnp_dtype``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // n_heads
    mlp_type: str = "swiglu"       # swiglu | gelu
    use_rope: bool = True
    rope_theta: float = 1e4
    sliding_window: int = 0        # 0 → full attention
    # --- MoE
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 1             # every k-th layer uses MoE FFN
    capacity_factor: float = 1.25
    # --- layer pattern
    mixer: str = "attn"            # attn | mamba | rwkv
    attn_every: int = 0            # hybrid: every k-th layer is attention
    # --- mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0         # 0 → ceil(d_model/16)
    # --- rwkv
    rwkv_head_size: int = 64
    # --- compute policy
    dtype: str = "bfloat16"
    remat: str = "full"            # none | dots | full
    train_microbatches: int = 0    # 0 = auto; capped to batch divisibility
    time_chunk: int = 64           # ssm/rwkv chunked-scan length
    q_block: int = 512             # flash-attention query block
    kv_block: int = 1024           # flash-attention kv block
    # --- modality stub (audio/vlm): leading frames come in as embeddings
    frontend_tokens: int = 0       # e.g. image patches / audio frames

    pad_heads_to: int = 0          # pad Q heads to a multiple (TP fix for
                                   # head counts that don't divide the mesh;
                                   # padded heads have zero output rows —
                                   # mathematically inert, §Perf A2)
    use_flash_kernel: bool = False  # Pallas fused attention (§Perf A3)

    # ------------------------------------------------------------- derived
    @property
    def n_heads_eff(self) -> int:
        """Padded head count.  Padding happens *within* each KV group (the
        head→KV mapping of real heads is unchanged; padded heads share a
        real KV head and have zero wo rows → exactly inert)."""
        if not self.pad_heads_to or self.n_heads % self.pad_heads_to == 0:
            return self.n_heads
        kv = self.n_kv_heads
        g = self.n_heads // kv
        for g_eff in range(g, g + self.pad_heads_to + 1):
            if (kv * g_eff) % self.pad_heads_to == 0:
                return kv * g_eff
        return self.n_heads

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dt_rank_(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (TP divisibility + MXU tiles)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def moe_ep_split(self) -> int:
        """Virtual-expert split so E·s equals the production data axis (16):
        mixtral (E=8) → 2, jamba (E=16) → 1.  Exact math — SwiGLU splits
        elementwise over F (models/moe.py)."""
        if not self.moe_experts:
            return 1
        e, axis = self.moe_experts, 16
        if e < axis and axis % e == 0 and self.d_ff % (axis // e) == 0:
            return axis // e
        return 1

    @property
    def period(self) -> int:
        """Scan period: smallest layer group that repeats verbatim."""
        p = 1
        if self.attn_every:
            p = math.lcm(p, self.attn_every)
        if self.moe_experts and self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        return p

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"period={self.period}")
        return self.n_layers // self.period

    def layer_kind(self, layer_idx: int) -> tuple[str, str]:
        """(mixer, ffn) for a global layer index."""
        if self.mixer == "attn":
            mixer = "attn"
        elif self.attn_every:
            # hybrid (Jamba): attention at position attn_every//2 of each
            # period, SSM elsewhere (1:7 interleave for attn_every=8)
            mixer = "attn" if (layer_idx % self.attn_every
                               == self.attn_every // 2) else self.mixer
        else:
            mixer = self.mixer
        if self.mixer == "rwkv":
            ffn = "channelmix"
        elif self.moe_experts and (layer_idx % self.moe_every
                                   == self.moe_every - 1):
            ffn = "moe"
        else:
            ffn = "mlp"
        return mixer, ffn

    def period_kinds(self) -> list[tuple[str, str]]:
        return [self.layer_kind(i) for i in range(self.period)]

    @property
    def torch_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    # ----------------------------------------------------------- counting
    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim_
        total = 2 * self.padded_vocab * d          # embed + lm_head
        for i in range(self.n_layers):
            mixer, ffn = self.layer_kind(i)
            if mixer == "attn":
                total += d * self.n_heads * hd        # q
                total += 2 * d * self.n_kv_heads * hd  # k, v
                total += self.n_heads * hd * d        # o
            elif mixer == "mamba":
                di, ds, dr = self.d_inner, self.mamba_d_state, self.dt_rank_
                total += d * 2 * di + di * self.mamba_d_conv
                total += di * (dr + 2 * ds) + dr * di + di * ds + di
                total += di * d
            elif mixer == "rwkv":
                total += 5 * d * d + d * d            # r,k,v,g,o + decay/first misc
            if ffn == "mlp":
                mult = 3 if self.mlp_type == "swiglu" else 2
                total += mult * d * self.d_ff
            elif ffn == "moe":
                total += d * self.moe_experts
                total += self.moe_experts * 3 * d * self.d_ff
            elif ffn == "channelmix":
                total += 2 * d * self.d_ff + d * d
            total += 2 * d                            # norms
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k of E experts)."""
        if not self.moe_experts:
            return self.param_count()
        d = self.d_model
        moe_layers = sum(1 for i in range(self.n_layers)
                         if self.layer_kind(i)[1] == "moe")
        inactive = (self.moe_experts - self.moe_top_k) * 3 * d * self.d_ff
        return self.param_count() - moe_layers * inactive

    def model_flops_per_token(self, kind: str = "train") -> float:
        """Analytic MODEL_FLOPS: 6·N_active per token for training,
        2·N_active for inference forward."""
        mult = 6.0 if kind == "train" else 2.0
        return mult * self.active_param_count()


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving smoke-test reduction."""
    smoke_experts = 4 if cfg.moe_experts else 0
    base = dict(
        n_layers=cfg.period * 2 if cfg.period > 1 else 2,
        d_model=128,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_ff=256, vocab_size=512, head_dim=32,
        moe_experts=smoke_experts,
        # Smoke configs are drop-free: with the production capacity factor
        # (1.25) the MoE capacity cutoff makes every token's kept/dropped
        # status depend on how *earlier* tokens routed, which breaks the
        # locality the receptive-field tests assert.  capacity_factor == E
        # gives cap == top_k·T — no drops, routing stays token-local.
        capacity_factor=float(smoke_experts) if smoke_experts
        else cfg.capacity_factor,
        time_chunk=16, q_block=64, kv_block=64,
        sliding_window=64 if cfg.sliding_window else 0,
        frontend_tokens=4 if cfg.frontend_tokens else 0,
        mamba_d_state=8, rwkv_head_size=32,
    )
    base.update(overrides)
    return replace(cfg, **base)
