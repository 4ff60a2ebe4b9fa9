"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060): prefill
over a whole prompt and the O(1)-state single-token decode.

Port of ``repro.models.ssm``.  The prefill's scan has two routes; the
caller picks one with ``apply_mamba_block``'s ``use_kernel`` (the wave
prefill from ``cfg.attn_kernel`` and the device, as the attention
kernels are picked; the full-sequence forward only with grad disabled,
since the kernel has no backward):

  * the kernel route: the scan goes through ``kernels.ssd_scan.ops.ssd``,
    the hand-written SSD kernel, in fp32 (its exact fp32 bodies), from a
    zero state (``ssd_via_kernel``);
  * the plain route: ``ssd_chunked``, a twin of the reference's chunked
    algorithm in fp32, and the training path's (plain autograd, as the
    reference differentiates its jnp scan).

Both need S <= chunk or S % chunk == 0, as the reference asserts: the
wave path groups prompts by exact length, so padding would change the
state.  The decode update, the causal conv and the gated norm are plain
PyTorch on either route (the reference has no kernel there).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import rmsnorm_gated

Params = Dict[str, torch.Tensor]


def dims(cfg: ModelConfig):
    """(d_inner, heads H, groups G, state N, head dim P, conv channels)."""
    s = cfg.ssm
    d_inner = s.d_inner(cfg.d_model)
    H = s.nheads(cfg.d_model)
    G, N, P = s.ngroups, s.state_size, s.head_dim
    return d_inner, H, G, N, P, d_inner + 2 * G * N


def param_shapes(cfg: ModelConfig):
    """The block's leaves, as the reference's ``init_mamba_block`` lays
    them out (``conv_w`` has its fan-in on axis 0)."""
    d = cfg.d_model
    d_inner, H, G, N, P, conv_dim = dims(cfg)
    return {"in_proj": (d, 2 * d_inner + 2 * G * N + H),
            "conv_w": (cfg.ssm.conv_kernel, conv_dim),
            "conv_b": (conv_dim,), "A_log": (H,), "D": (H,),
            "dt_bias": (H,), "norm_scale": (d_inner,),
            "out_proj": (d_inner, d)}


#: Leaves the reference initialises to fixed values, in fp32 whatever the
#: parameters' dtype: A = -exp(A_log) spans [-16, -1], D is one, dt_bias
#: zero.  (A random A_log would make A wrong and the prefill state
#: overflow.)
FP32_LEAVES = ("A_log", "D", "dt_bias")


def fixed_leaf(name: str, shape, dtype, device) -> Optional[torch.Tensor]:
    """The reference's fixed initial value of a mamba leaf (``A_log``
    log(linspace(1, 16, H)), ``D`` ones, ``dt_bias`` zeros, all fp32;
    ``norm_scale`` ones and ``conv_b`` zeros in ``dtype``), else None."""
    if name == "A_log":
        a0 = torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32,
                            device=device)
        return torch.log(a0).expand(shape).contiguous()
    if name == "D":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if name == "dt_bias":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if name == "norm_scale":
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "conv_b":
        return torch.zeros(shape, dtype=dtype, device=device)
    return None


def _causal_conv(w: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d by k shifted adds, then silu.  x: (B, S,
    C); w: (k, C)."""
    k, S = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return F.silu(out + b)


def _segsum_decay(a_cum: torch.Tensor) -> torch.Tensor:
    """exp(a_cum[..., i] - a_cum[..., j]) for i >= j, else 0: (..., Q) ->
    (..., Q, Q).  Masked before the exp, whose upper-triangle arguments
    are positive and would overflow."""
    Q = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                 device=a_cum.device))
    return torch.exp(diff.masked_fill(~mask, -math.inf))


def _chunk_of(S: int, chunk: int) -> int:
    """min(chunk, S), which must divide S (the reference asserts it)."""
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"SSD scan: a prompt of {S} positions is longer "
                         f"than the chunk ({chunk}) and not a multiple of "
                         f"it")
    return Q


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """The SSD scan, the reference's chunked algorithm in fp32.

    x: (b, S, H, P); dt: (b, S, H) (already softplus'ed); A: (H,)
    negative decay rates; B, C: (b, S, G, N) with H % G == 0;
    initial_state: None (zeros) or (b, H, P, N).  Returns (y (b, S, H, P)
    fp32, final state (b, H, P, N) fp32).
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Hg = H // G
    Q = _chunk_of(S, chunk)
    nc = S // Q
    f32 = torch.float32
    xdt = x.to(f32) * dt[..., None].to(f32)
    a_bar = dt.to(f32) * A.to(f32)

    x_c = xdt.reshape(b, nc, Q, G, Hg, P)
    a_c = a_bar.reshape(b, nc, Q, G, Hg)
    B_c = B.to(f32).reshape(b, nc, Q, G, N)
    C_c = C.to(f32).reshape(b, nc, Q, G, N)

    a_cum = torch.cumsum(a_c, dim=2)  # (b, nc, Q, G, Hg)
    a_last = a_cum[:, :, -1]          # (b, nc, G, Hg)

    # Intra-chunk: the quadratic dual form.
    L = _segsum_decay(a_cum.movedim(2, -1))  # (b, nc, G, Hg, Q, Q)
    y_diag = torch.einsum("bcqgn,bckgn,bcghqk,bckghp->bcqghp",
                          C_c, B_c, L, x_c)

    # Each chunk's contribution to the carried state.
    decay_states = torch.exp(a_last[:, :, None] - a_cum)
    states = torch.einsum("bckgn,bckgh,bckghp->bcghpn", B_c, decay_states,
                          x_c)

    # The recurrence over chunks.
    chunk_decay = torch.exp(a_last)  # (b, nc, G, Hg)
    if initial_state is None:
        s = torch.zeros(b, G, Hg, P, N, dtype=f32, device=x.device)
    else:
        s = initial_state.reshape(b, G, Hg, P, N).to(f32)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, ..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, G, Hg, P, N)

    # Inter-chunk output: the state entering the chunk, decayed to q.
    y_off = torch.einsum("bcqgn,bcghpn,bcqgh->bcqghp", C_c, prev_states,
                         torch.exp(a_cum))
    y = (y_diag + y_off).reshape(b, S, H, P)
    return y, s.reshape(b, H, P, N)


def ssd_via_kernel(x, dt, A, B, C, chunk: int):
    """The scan through ``ops.ssd`` (the SSD kernel on CUDA tensors, its
    plain recurrence on CPU ones), from a zero state, in fp32: heads
    folded into the kernel's rows, (b, S, H, P) -> (b * H, S, P), B and
    C broadcast from G groups to H heads, chunk ``min(chunk, S)``.  Same
    arguments and results as ``ssd_chunked`` without ``initial_state``."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = _chunk_of(S, chunk)
    f32 = torch.float32

    def rows(t):  # (b, S, H, ...) -> (b * H, S, ...)
        return t.to(f32).movedim(2, 1).reshape(b * H, S, *t.shape[3:]) \
            .contiguous()

    def heads(t):  # (b, S, G, N) -> (b * H, S, N)
        return rows(t.repeat_interleave(H // G, dim=2))

    y, state = ssd_ops.ssd(rows(x), rows(dt), A.to(f32).repeat(b),
                           heads(B), heads(C), chunk=Q)
    return (y.reshape(b, H, S, P).movedim(1, 2),
            state.reshape(b, H, P, N))


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, H, _, _, _, conv_dim = dims(cfg)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
            zxbcdt[..., -H:])


def apply_mamba_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      initial_state=None, *, use_kernel: bool = False):
    """x: (B, S, d) -> (out (B, S, d), {"state": final SSM state (B, H,
    P, N) fp32, "conv": the last k - 1 raw conv inputs (B, k - 1, conv
    channels) in x's dtype}).  The scan takes the kernel route with
    ``use_kernel``, else the plain one (module docstring); the kernel
    starts from a zero state, so ``initial_state`` on that route
    raises."""
    d_inner, H, G, N, P, conv_dim = dims(cfg)
    B_, S_, _ = x.shape
    k = cfg.ssm.conv_kernel
    z, xBC, dt_raw = _split(cfg, x @ p["in_proj"])
    # The raw inputs decode's conv window starts from; zeros ahead of a
    # prompt shorter than the window (the causal conv's own padding).
    conv_tail = F.pad(xBC, (0, 0, max(k - 1 - S_, 0), 0))[:, -(k - 1):]
    xBC = _causal_conv(p["conv_w"], p["conv_b"], xBC)
    x_ssm = xBC[..., :d_inner].reshape(B_, S_, H, P)
    B_ssm = xBC[..., d_inner:d_inner + G * N].reshape(B_, S_, G, N)
    C_ssm = xBC[..., d_inner + G * N:].reshape(B_, S_, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if use_kernel:
        if initial_state is not None:
            raise ValueError("the SSD kernel scans from a zero state: "
                             "initial_state needs attn_kernel='off'")
        y, state = ssd_via_kernel(x_ssm, dt, A, B_ssm, C_ssm,
                                  cfg.ssm.chunk_size)
    else:
        y, state = ssd_chunked(x_ssm, dt, A, B_ssm, C_ssm,
                               cfg.ssm.chunk_size, initial_state)
    y = y + x_ssm.float() * p["D"][None, None, :, None]
    y = y.reshape(B_, S_, d_inner).to(x.dtype)
    y = rmsnorm_gated(p["norm_scale"], y, z)
    return y @ p["out_proj"], {"state": state, "conv": conv_tail}


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None,
                     conv_dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """Zeros: ``conv`` (batch, k - 1, conv channels) in ``conv_dtype``
    (bf16, the reference's), ``state`` (batch, H, P, N) fp32."""
    _, H, _, N, P, conv_dim = dims(cfg)
    return {"conv": torch.zeros(batch, cfg.ssm.conv_kernel - 1, conv_dim,
                                dtype=conv_dtype, device=device),
            "state": torch.zeros(batch, H, P, N, dtype=torch.float32,
                                 device=device)}


def apply_mamba_decode(cfg: ModelConfig, p: Params, cache, x: torch.Tensor):
    """One token: x (B, 1, d) -> (out (B, 1, d), the new cache): the conv
    window rolls by one, the state takes one O(1) update.  The new cache's
    ``conv`` is in the promoted type of the old window and x (as the
    reference's concatenation gives it)."""
    d_inner, H, G, N, P, conv_dim = dims(cfg)
    B_ = x.shape[0]
    z, xBC, dt_raw = _split(cfg, x[:, 0] @ p["in_proj"])

    conv = cache["conv"]
    wt = torch.promote_types(conv.dtype, xBC.dtype)
    win = torch.cat([conv.to(wt), xBC[:, None, :].to(wt)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", win.float(), p["conv_w"].float())
    xBC = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)

    x_ssm = xBC[..., :d_inner].reshape(B_, H, P)
    B_ssm = xBC[..., d_inner:d_inner + G * N].reshape(B_, G, N)
    C_ssm = xBC[..., d_inner + G * N:].reshape(B_, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))

    Hg = H // G
    xdt = x_ssm.float() * dt[..., None]
    inc = torch.einsum("bgn,bghp->bghpn", B_ssm.float(),
                       xdt.reshape(B_, G, Hg, P)).reshape(B_, H, P, N)
    state = cache["state"] * dA[..., None, None] + inc
    y = torch.einsum("bgn,bghpn->bghp", C_ssm.float(),
                     state.reshape(B_, G, Hg, P, N)).reshape(B_, H, P)
    y = y + x_ssm.float() * p["D"][None, :, None]
    y = y.reshape(B_, 1, d_inner).to(x.dtype)
    y = rmsnorm_gated(p["norm_scale"], y, z[:, None, :])
    return y @ p["out_proj"], {"conv": win[:, 1:], "state": state}
