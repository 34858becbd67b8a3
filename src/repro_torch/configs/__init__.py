"""Assigned architecture registry: ``get_config(arch)`` / ``ARCHS``."""

from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeCell, reduced

ARCHS = [
    "jamba-v0.1-52b",
    "mixtral-8x22b",
    "mixtral-8x7b",
    "musicgen-medium",
    "starcoder2-7b",
    "granite-3-2b",
    "stablelm-1.6b",
    "granite-3-8b",
    "rwkv6-3b",
    "llava-next-34b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.smoke_config()


def supports_shape(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (DESIGN §6)."""
    if shape_name != "long_500k":
        return True, ""
    sub_quadratic = (cfg.mixer in ("mamba", "rwkv") or cfg.attn_every > 0
                     or cfg.sliding_window > 0)
    if not sub_quadratic:
        return False, ("skipped: pure full attention — 524288-token KV "
                       "cache/prefill is O(S²) without windowing")
    return True, ""


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeCell", "get_config",
           "get_smoke_config", "reduced", "supports_shape"]
