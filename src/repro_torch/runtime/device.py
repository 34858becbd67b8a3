"""Device selection for the port's entry points.

Every entry point (``Mapper``, ``MappingPlan``, ``RefinementEngine``,
the ``viem`` CLI) runs on ``cuda`` unless the caller passes
``device="cpu"``.  Without a card the default raises: the port never
falls back to the CPU behind the caller's back.
"""

from __future__ import annotations

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``torch.device`` for an entry point's ``device`` argument
    (``None`` means ``"cuda"``); raises when CUDA is asked for and no
    card is present."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch "
                           "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; choose 'cuda' or "
                         f"'cpu'")
    return dev
