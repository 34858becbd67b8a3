"""The plain reference that decides ``correct``.

NumPy only (the control's bfloat16 sums use PyTorch on the CPU).  It
imports nothing of the program and works every number out from its own
definitions: machine distances from the machine's description, the
objective from the edge lists the benchmark generated, and the remap
loop's live graphs from the windows the benchmark fed.
"""

from .distances import distance_fn
from .objective import is_bijection, objective, objective_bf16
from .windows import edge_l1, ema_windows

__all__ = ["distance_fn", "edge_l1", "ema_windows", "is_bijection",
           "objective", "objective_bf16"]
