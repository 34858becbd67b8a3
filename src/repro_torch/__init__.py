"""PyTorch/CUDA port of the VieM reproduction (the JAX package ``repro``
stays beside it as the reference).

The port runs the flat device mapping path —
``Mapper(machine, MappingSpec(engine="device", backend="pallas")).map(g)``
— on an NVIDIA H100 through two hand-written CUDA kernels (the QAP
objective and the sparse pair gains, :mod:`repro_torch.kernels`), with
plain PyTorch versions of both for CPU tensors.  Entry points take a
``device`` argument: ``"cuda"`` by default, ``"cpu"`` on request; they
never fall back.  The package imports torch and numpy only — never jax
and nothing of ``repro``; where it needs a host module of ``repro`` it
keeps its own copy.
"""

__version__ = "0.1.0"
