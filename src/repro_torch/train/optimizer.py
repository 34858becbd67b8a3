"""AdamW with cosine schedule and global-norm clipping — the JAX
package's ``train/optimizer.py`` on torch tensors.

Memory layout: params in the model dtype (bf16), first/second moments in
f32 (the memory-lean production choice — DESIGN §5).  The update math runs
in f32 and casts back, in the reference's order of operations.

The JAX update is functional and its jitted step donates the old state;
here :func:`adamw_update` writes the parameters, ``m``, ``v`` and
``step`` in place under ``torch.no_grad()`` — a functional copy of the
state would not fit beside the live one at full width.  ``step``, the
learning rate, the gradient norm and the clip scale stay device tensors,
so an update reads nothing back to the host.

Parameters are named: ``params`` is a module (its ``named_parameters()``)
or a dict of tensors, and ``grads``, ``m`` and ``v`` are dicts keyed by
the same names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["OptConfig", "adamw_update", "global_norm", "init_opt_state",
           "named_params", "schedule"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def named_params(params) -> dict:
    """{name: tensor} of a module's parameters, or the dict itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(opt: OptConfig, step):
    """The learning rate at ``step`` (a device tensor) as a float32
    device tensor: linear warm-up, then cosine decay to min_lr_frac."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = opt.min_lr_frac + (1 - opt.min_lr_frac) * cos
    return opt.lr * warm * frac


def init_opt_state(params):
    """Zero float32 moments named as ``params``, and an int32 step 0,
    on the parameters' device."""
    named = named_params(params)
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in named.items()}
    device = next(iter(named.values())).device
    return {"m": zeros,
            "v": {k: z.clone() for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors):
    """√(Σ x²) over an iterable of tensors, summed in float32 in order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tensors))


@torch.no_grad()
def adamw_update(params, grads, opt_state, opt: OptConfig):
    """One AdamW step in place.  Returns (params, opt_state, metrics)
    with the same objects updated; metrics ``grad_norm`` and ``lr`` are
    float32 device tensors."""
    named = named_params(params)
    if set(grads) != set(named):
        raise ValueError(f"adamw_update: gradients for {sorted(grads)}, "
                         f"parameters {sorted(named)}")
    step = opt_state["step"]
    step.add_(1)
    lr = schedule(opt, step)
    gnorm = global_norm(grads[k] for k in named)
    scale = torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)

    b1, b2 = opt.b1, opt.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    for k, p in named.items():
        m, v = opt_state["m"][k], opt_state["v"][k]
        g = grads[k].to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (mh / (torch.sqrt(vh) + opt.eps)
                           + opt.weight_decay * pf))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
