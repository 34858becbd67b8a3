"""Training/serving substrate: optimizer, loss, step functions, compression
— the JAX package's ``train`` on torch tensors (one card: no specs)."""

from .loss import IGNORE, cross_entropy, lm_loss
from .optimizer import OptConfig, adamw_update, init_opt_state, schedule
from .steps import (build_prefill_step, build_serve_step, build_train_step,
                    init_train_state, prefill_step, serve_step, train_step)

__all__ = ["IGNORE", "cross_entropy", "lm_loss", "OptConfig",
           "adamw_update", "init_opt_state", "schedule",
           "build_prefill_step", "build_serve_step", "build_train_step",
           "init_train_state", "prefill_step", "serve_step", "train_step"]
