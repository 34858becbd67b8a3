"""Hand-written CUDA kernels of the port and their plain twins.

  qap_objective — K1: the edge-list QAP objective (``csrc/qap_objective
                  .cu``), replacing the JAX package's three Pallas
                  reductions in ``kernels/qap_objective.py``
  pair_gain     — K2: sparse per-pair swap gains (``csrc/pair_gain.cu``),
                  replacing ``pair_gains_pallas``; also the engine's
                  ``edge_objective``
  config        — ``KernelConfig``: bucket/device-derived geometry and
                  lossless int8/int16 distance-table packing
  pad           — the one set of padding helpers (inert, append-only)
  cuda          — nvcc build, ctypes loading and launch counting

Every wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain PyTorch version for CPU tensors; nothing here is built or
loaded at import.  The dense swap-gain matrix (K3) and flash attention
(K4) are not ported yet (ROADMAP.md).
"""

from . import pad
from .config import KernelConfig, derive_kernel_config, quantize_table
from .pair_gain import (PAIR_GAIN_KERNEL, edge_objective, pair_gains,
                        pair_gains_plain)
from .qap_objective import (OBJECTIVE_KERNEL, qap_objective_edges,
                            qap_objective_plain)

__all__ = ["pad", "KernelConfig", "derive_kernel_config", "quantize_table",
           "PAIR_GAIN_KERNEL", "edge_objective", "pair_gains",
           "pair_gains_plain", "OBJECTIVE_KERNEL", "qap_objective_edges",
           "qap_objective_plain", "KERNELS"]

# every hand-written kernel on the mapping path, by name
KERNELS = {"qap_objective": OBJECTIVE_KERNEL, "pair_gains": PAIR_GAIN_KERNEL}
