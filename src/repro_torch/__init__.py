"""PyTorch/CUDA port of the serving runtime in ``repro``.

The layout mirrors ``repro`` module for module: ``configs``, ``models``,
``kernels``, ``serving`` and ``launch`` sit at the same relative paths,
so each module's counterpart is found by name.  The package imports
``torch`` and numpy only; it keeps its own copy of every framework-free
piece it needs and never imports ``jax`` or ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``repro_torch.device``).  The two paged attention
hot paths are hand-written Hopper kernels (``repro_torch/csrc``), built
with ``nvcc`` at first use; CPU tensors take their plain PyTorch
versions.
"""
