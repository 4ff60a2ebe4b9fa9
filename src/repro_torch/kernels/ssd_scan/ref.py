"""Plain PyTorch version of the SSD chunk scan: the naive recurrence.

Twin of ``repro.kernels.ssd_scan.ref``: the SSM recurrence step by step
(O(S) steps) in fp32.  It is the CPU path of ``ops.ssd`` and what the
CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(xdt, a, b, c, *, heads_per_group: int = 1):
    """Sequential SSM recurrence (the definition).

    xdt: (BH, S, P); a: (BH, S); b, c: (BH / heads_per_group, S, N), row
    bh of xdt reading row bh // heads_per_group of b and c (its group's;
    1: the reference's per-row b and c, expanded here by
    ``repeat_interleave`` otherwise)
    state_t = exp(a_t) * state_{t-1} + xdt_t (outer) b_t
    y_t = c_t . state_t
    Returns (y (BH, S, P) in xdt's dtype, final state (BH, P, N) fp32).
    """
    if heads_per_group != 1:
        b = b.repeat_interleave(heads_per_group, dim=0)
        c = c.repeat_interleave(heads_per_group, dim=0)
    BH, S, P = xdt.shape
    N = b.shape[2]
    x32, a32 = xdt.float(), a.float()
    b32, c32 = b.float(), c.float()
    state = torch.zeros(BH, P, N, dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(S):
        state = torch.exp(a32[:, t])[:, None, None] * state \
            + x32[:, t, :, None] * b32[:, t, None, :]
        ys.append(torch.einsum("bn,bpn->bp", c32[:, t], state))
    y = torch.stack(ys, dim=1) if ys else x32.new_zeros(BH, 0, P)
    return y.to(xdt.dtype), state
