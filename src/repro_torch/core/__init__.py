"""The analytic co-design engine's numpy/stdlib modules, copied from
``repro.core`` so that the port imports nothing of ``repro``: the chip
and server model (``hardware``), TCO (``tco``), the paper's workloads
(``workloads``; ``from_model_config`` takes the port's configs), the
inference simulator and mapping search (``perf``), the SCLD storage model
(``sparsity``), the CC-MEM simulator (``ccmem``), the two-phase co-design
search (``explore``) and the roofline terms (``roofline``, with the
H100's constants).  The copies import only each other, and launch
nothing on a device."""
