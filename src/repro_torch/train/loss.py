"""Masked cross-entropy LM loss over padded-vocab logits — the JAX
package's ``train/loss.py`` on torch tensors."""

from __future__ import annotations

import torch

IGNORE = -1

__all__ = ["IGNORE", "cross_entropy", "lm_loss"]


def cross_entropy(logits, labels):
    """logits: (B, T, Vp); labels: (B, T) int with IGNORE for masked
    positions (modality-frontend slots, padding).  Mean over valid.

    Returns (mean, count); both stay device tensors (the count is
    clamped to 1 on the device, so nothing is read back)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0)
    if hasattr(lf, "placements"):
        # vocab sharded (a DTensor): pick by a mask and a sum, which
        # shards over the vocab (one nonzero term: exact)
        vocab = torch.arange(lf.shape[-1], device=lf.device)
        picked = torch.where(vocab == safe[..., None], lf, 0.0).sum(-1)
    else:
        # torch.gather takes an int64 index
        picked = torch.gather(lf, -1, safe.to(torch.int64)[..., None])[..., 0]
    nll = (lse - picked) * valid
    count = valid.sum().clamp(min=1).to(torch.int32)    # jnp's int32
    return nll.sum() / count, count


def lm_loss(params, batch, cfg, forward_fn, aux_weight: float = 0.01):
    frontend = batch.get("frontend")
    logits, aux = forward_fn(params, batch["tokens"], cfg,
                             frontend=frontend)
    labels = batch["labels"]
    if frontend is not None:
        # frontend slots carry no labels
        b, f = labels.shape[0], frontend.shape[1]
        pad = torch.full((b, f), IGNORE, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    ce, count = cross_entropy(logits, labels)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux, "tokens": count}
