"""Public wrapper for the SSD chunk scan."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan


def ssd(x, dt, A, b, c, *, chunk: int = 128):
    """The mamba block's calling convention.

    x: (BH, S, P); dt: (BH, S) (already softplus'ed); A: per-row decay
    (BH,); b, c: (BH, S, N).  Returns (y, final_state).  The pre-scale
    (xdt = x * dt, a = dt * A) is plain PyTorch in the inputs' dtype; the
    scan is the CUDA kernel for CUDA tensors and the plain recurrence for
    CPU tensors.
    """
    xdt = x * dt[..., None]
    a = dt * A[:, None]
    if x.device.type == "cuda":
        return ssd_scan(xdt, a, b, c, chunk=chunk)
    return ssd_scan_ref(xdt, a, b, c)
