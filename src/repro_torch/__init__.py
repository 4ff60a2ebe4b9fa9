"""PyTorch/CUDA port of the serving runtime and the training substrate in
``repro``.

The layout mirrors ``repro`` module for module: ``configs``, ``models``,
``kernels``, ``serving``, ``training`` and ``launch`` sit at the same
relative paths,
so each module's counterpart is found by name.  The package imports
``torch`` and numpy only; it keeps its own copy of every framework-free
piece it needs and never imports ``jax`` or ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``repro_torch.device``).  Every kernel the JAX
package wrote in Pallas is a hand-written Hopper kernel here
(``repro_torch/csrc``): the paged and dense attention of the serving
path, and the SCLD matmul, the SSD scan and blocked flash attention
behind their own entry points.  They are built with ``nvcc`` at first
use; CPU tensors take their plain PyTorch versions.  Training
differentiates the plain attention and scan with torch autograd (no
kernel has a backward; the no-grad forward takes the kernels).
``core`` holds copies of the analytic co-design modules, ``examples``
the SCLD example, the quickstart and the training example.
"""
