"""The analytic co-design engine's numpy/stdlib modules, copied from
``repro.core`` so that the port imports nothing of ``repro``: the chip
and server model (``hardware``), TCO (``tco``), the paper's workloads
(``workloads``), the inference simulator and mapping search (``perf``)
and the SCLD storage model (``sparsity``).  The copies import only each
other.  ``workloads.from_model_config`` (an adapter from a JAX model
config) is left out."""
