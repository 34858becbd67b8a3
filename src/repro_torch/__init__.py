"""PyTorch/CUDA port of the VieM reproduction (the JAX package ``repro``
stays beside it as the reference).

The port runs the device mapping paths —
``Mapper(machine, MappingSpec(engine="device", backend="pallas")).map(g)``,
flat or multilevel (``multilevel=MultilevelSpec()``), batched
(``Mapper.map_many``) and warm-started (``MappingPlan.execute_warm``) —
on an NVIDIA H100 through two hand-written CUDA kernels (the QAP
objective and the sparse pair gains, each with a lane axis that covers
a batch in one launch), the dense gain matrix
(``Mapper.gain_matrix``) through a third, and the host search drivers
(``engine="host"``, the default) and the ``viem``/``evaluator`` CLIs on
top.  The LM substrate's serving path
(:func:`repro_torch.launch.serve.serve`: prefill + greedy decode of the
dense configs) runs its attention through a fourth kernel, flash
attention.  Each kernel (:mod:`repro_torch.kernels`) has a plain PyTorch
version for CPU tensors.  Entry points take a
``device`` argument: ``"cuda"`` by default, ``"cpu"`` on request; they
never fall back.  The package imports torch and numpy only — never jax
and nothing of ``repro``; where it needs a host module of ``repro`` it
keeps its own copy.
"""

__version__ = "0.1.0"
