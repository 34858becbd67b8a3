"""The serving step of the JAX package's ``train/steps.py``.  Training,
its optimizer and the jit builders are not ported (ROADMAP item 7)."""

from __future__ import annotations

import torch

from ..models.transformer import decode_step

__all__ = ["serve_step"]


def serve_step(params, token, caches, step_idx: int, cfg):
    """One greedy decode step against the caches.  ``step_idx`` is a host
    int.  Returns (next token (B, 1) int32, caches); the argmax keeps the
    first maximum, as ``jnp.argmax`` does."""
    logits, caches = decode_step(params, token, caches, step_idx, cfg)
    next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return next_token[:, None], caches
