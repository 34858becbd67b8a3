"""Hand-written CUDA kernels of the port and their plain twins.

  qap_objective — K1: the edge-list QAP objective (``csrc/qap_objective
                  .cu``), replacing the JAX package's three Pallas
                  reductions in ``kernels/qap_objective.py``; a lane axis
                  takes a batch's B objectives in one launch, or those of
                  B permutations of one shared graph (the portfolio's)
  pair_gain     — K2: sparse per-pair swap gains (``csrc/pair_gain.cu``),
                  replacing ``pair_gains_pallas``, with the same lane
                  axis; also the engine's ``edge_objective``
  swap_gain     — K3: the dense O(n²) pair-exchange gain matrix
                  (``csrc/swap_gain.cu``), replacing ``swap_gain_matrix``.
                  As in the JAX package it is a reference path that plans
                  never select for refinement (``Mapper.gain_matrix`` and
                  ``ops.gain_matrix`` reach it) and it is not in
                  ``__all__``
  flash_attention — K4: causal / sliding-window GQA attention forward,
                  replacing ``flash_attention_kernel``; the LM path's
                  attention core.  Two routes by dtype: bfloat16 through
                  ``csrc/flash_attention_sm90.cu`` (wgmma, TMA), float32
                  through ``csrc/flash_attention.cu`` (3xTF32 wgmma, TMA)
  contract      — graph contraction for the multilevel V-cycle (heavy-
                  edge matching, sorted-run edge collapsing): the JAX
                  package's plain ``jnp`` code, as torch ops (no kernel)
  ops           — device wrappers (``gain_matrix``, ``objective``) and
                  their ``*_ref`` twins
  ref           — plain PyTorch oracles of the kernels
  config        — ``KernelConfig``: bucket/device-derived geometry and
                  lossless int8/int16 distance-table packing
  pad           — the one set of padding helpers (inert, append-only)
  cuda          — nvcc build, ctypes loading and launch counting

Every wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain PyTorch version for CPU tensors; nothing here is built or
loaded at import.
"""

from . import ops, pad, ref
from .config import KernelConfig, derive_kernel_config, quantize_table
from .flash_attention import (FLASH_F32_KERNEL, FLASH_KERNEL,
                              flash_attention_kernel)
from .pair_gain import (PAIR_GAIN_KERNEL, edge_objective, pair_gains,
                        pair_gains_plain)
from .qap_objective import (OBJECTIVE_KERNEL, qap_objective_edges,
                            qap_objective_plain)
from .swap_gain import SWAP_GAIN_KERNEL, swap_gain_matrix  # noqa: F401

__all__ = ["ops", "pad", "ref", "KernelConfig", "derive_kernel_config",
           "quantize_table", "FLASH_KERNEL", "FLASH_F32_KERNEL",
           "flash_attention_kernel",
           "PAIR_GAIN_KERNEL", "edge_objective", "pair_gains", "pair_gains_plain", "OBJECTIVE_KERNEL",
           "qap_objective_edges", "qap_objective_plain", "KERNELS"]

# every hand-written kernel of the port, by name; K4 has one entry per
# route, so a run shows which route each path took
KERNELS = {"qap_objective": OBJECTIVE_KERNEL, "pair_gains": PAIR_GAIN_KERNEL,
           "swap_gain_matrix": SWAP_GAIN_KERNEL,
           "flash_attention": FLASH_KERNEL,
           "flash_attention_f32": FLASH_F32_KERNEL}
