"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060): prefill
over a whole prompt and the O(1)-state single-token decode.

Port of ``repro.models.ssm``.  The prefill's scan has two routes; the
caller picks one with ``apply_mamba_block``'s ``use_kernel`` (the wave
prefill from ``cfg.attn_kernel`` and the device, as the attention
kernels are picked; the full-sequence forward only with grad disabled,
since the kernel has no backward):

  * the kernel route: the scan goes through ``kernels.ssd_scan.ops.ssd``,
    the hand-written SSD kernel, in fp32 (its 3xTF32 bodies), from a
    zero state (``ssd_via_kernel``);
  * the plain route: ``ssd_chunked``, a twin of the reference's chunked
    algorithm in fp32, and the training path's (plain autograd, as the
    reference differentiates its jnp scan).

Both need S <= chunk or S % chunk == 0, as the reference asserts: the
wave path groups prompts by exact length, so padding would change the
state.  The decode update, the causal conv and the gated norm are plain
PyTorch on either route (the reference has no kernel there).

Over a ``model`` mesh axis (``mesh=``; the leaves placed by
``sharding.mamba_spec``) each shard runs its own heads — projection onto
its [z | x B C | dt] columns, causal conv, scan (the kernel once a
shard, on its b x H/m folded rows) or one-step update, and D skip — as
the reference's "heads are sharded over the model mesh axis".  The
gated RMSNorm normalises over the whole d_inner, so its sum of squares
is a ``psum`` of the shards' (``_sum_squares``), and ``out_proj``'s
row-parallel partials are ``psum``med.  The collectives are the
autograd-aware ones.  Where the heads do not divide the axis the block
is whole on every shard and nothing is summed.  Over data axes above 1
(serving) each place runs its own rows of the batch on its model
shard's heads — the scan once a place on its b / d x H / m folded rows —
and the sums stay over ``model`` only.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import rmsnorm_gated
from repro_torch.parallel import sharding

Params = Dict[str, torch.Tensor]


def dims(cfg: ModelConfig, ways: int = 1):
    """(d_inner, heads H, groups G, state N, head dim P, conv channels),
    of one of ``ways`` shards cutting the heads
    (``sharding.mamba_shard_size``): d_inner and H divided."""
    s = cfg.ssm
    d_inner = s.d_inner(cfg.d_model) // ways
    H = s.nheads(cfg.d_model) // ways
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
    C by group, (b, S, G, N) -> (b * G, S, N) with H / G heads a group
    (row bh reads group row bh // (H / G); never repeated a head), chunk
    ``min(chunk, S)``.  Same arguments and results as ``ssd_chunked``
    without ``initial_state``."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = _chunk_of(S, chunk)
    f32 = torch.float32

    def rows(t):  # (b, S, K, ...) -> (b * K, S, ...)
        return t.to(f32).movedim(2, 1).reshape(
            b * t.shape[2], S, *t.shape[3:]).contiguous()

    y, state = ssd_ops.ssd(rows(x), rows(dt), A.to(f32).repeat(b),
                           rows(B), rows(C), chunk=Q,
                           heads_per_group=H // G)
    return (y.reshape(b, H, S, P).movedim(1, 2),
            state.reshape(b, H, P, N))


def _split(dm, zxbcdt: torch.Tensor):
    """(z, xBC, dt_raw) of the packed projection, ``dm`` = ``dims``."""
    d_inner, H, _, _, _, conv_dim = dm
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
            zxbcdt[..., -H:])


def _ways(p: Params, mesh) -> int:
    """The shards the block's heads are cut over: the ``model`` axis size
    where ``in_proj`` is placed cut, else 1."""
    if sharding.cut_dim(p["in_proj"]) is None:
        return 1
    return sharding.axes_size(mesh, sharding.TP_AXIS)


def _sum_squares(g, mesh):
    """The gated norm's fp32 sum of squares over the whole d_inner: each
    shard's over its columns, summed over the shards (``psum``)."""
    return sharding.psum(sharding.smap(
        lambda t: t.square().sum(-1, keepdim=True), g, mesh=mesh))


def _gated_norm(cfg: ModelConfig, scale, y, z, ways: int, mesh):
    """``rmsnorm_gated`` of y by z; over ``ways`` > 1 shards holding
    d_inner / ways columns each, with ``_sum_squares`` for the mean over
    all d_inner columns."""
    if ways == 1:
        return sharding.smap(rmsnorm_gated, scale, y, z, mesh=mesh)
    g = sharding.smap(
        lambda y_, z_: (y_ * F.silu(z_.float()).to(y_.dtype)).float(),
        y, z, mesh=mesh)
    ss = _sum_squares(g, mesh)
    n = dims(cfg)[0]
    return sharding.smap(
        lambda g_, s_, sc, y_: (g_ * torch.rsqrt(s_ / n + 1e-6)
                                * sc.float()).to(y_.dtype),
        g, ss, scale, y, mesh=mesh)


def _out(cfg: ModelConfig, p: Params, y, z, ways: int, mesh):
    """Gated norm, then ``out_proj`` (row-parallel over the shards: a
    ``psum`` of their partials)."""
    y = sharding.smap(lambda y_, w: y_ @ w,
                      _gated_norm(cfg, p["norm_scale"], y, z, ways, mesh),
                      p["out_proj"], mesh=mesh)
    return sharding.psum(y) if ways > 1 else y


def _labelled(cfg: ModelConfig, state, conv, ways: int, mesh):
    """The per-shard cache results placed as ``sharding.wave_cache_specs``
    places the caches: the state cut on its heads, the conv window by
    components."""
    if ways == 1:
        return {"state": state, "conv": conv}
    nd = len(conv.parts[0].shape)
    return {"state": sharding.Sharded(state.parts, 1, mesh),
            "conv": sharding.Sharded(
                conv.parts, nd - 1, mesh,
                comps=sharding.mamba_components(cfg, "conv"))}


def apply_mamba_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      initial_state=None, *, use_kernel: bool = False,
                      mesh=None):
    """x: (B, S, d) -> (out (B, S, d), {"state": final SSM state (B, H,
    P, N) fp32, "conv": the last k - 1 raw conv inputs (B, k - 1, conv
    channels) in x's dtype}).  The scan takes the kernel route with
    ``use_kernel``, else the plain one (module docstring); the kernel
    starts from a zero state, so ``initial_state`` on that route
    raises.  ``mesh``: p, x (equal on every model shard) and
    ``initial_state`` placed on it, the results too (module
    docstring)."""
    ways = _ways(p, mesh)
    dm = dims(cfg, ways)
    k = cfg.ssm.conv_kernel

    def heads(p_, x_, s0):
        d_inner, H, G, N, P, _ = dm
        B_, S_, _ = x_.shape
        z, xBC, dt_raw = _split(dm, x_ @ p_["in_proj"])
        # The raw inputs decode's conv window starts from; zeros ahead of
        # a prompt shorter than the window (the causal conv's own padding).
        conv_tail = F.pad(xBC, (0, 0, max(k - 1 - S_, 0), 0))[:, -(k - 1):]
        xBC = _causal_conv(p_["conv_w"], p_["conv_b"], xBC)
        x_ssm = xBC[..., :d_inner].reshape(B_, S_, H, P)
        B_ssm = xBC[..., d_inner:d_inner + G * N].reshape(B_, S_, G, N)
        C_ssm = xBC[..., d_inner + G * N:].reshape(B_, S_, G, N)
        dt = F.softplus(dt_raw.float() + p_["dt_bias"])
        A = -torch.exp(p_["A_log"])
        if use_kernel:
            if s0 is not None:
                raise ValueError("the SSD kernel scans from a zero state: "
                                 "initial_state needs attn_kernel='off'")
            y, state = ssd_via_kernel(x_ssm, dt, A, B_ssm, C_ssm,
                                      cfg.ssm.chunk_size)
        else:
            y, state = ssd_chunked(x_ssm, dt, A, B_ssm, C_ssm,
                                   cfg.ssm.chunk_size, s0)
        y = y + x_ssm.float() * p_["D"][None, None, :, None]
        return (y.reshape(B_, S_, d_inner).to(x_.dtype), z, state,
                conv_tail)

    y, z, state, conv = sharding.smap(heads, p, x, initial_state, mesh=mesh)
    return (_out(cfg, p, y, z, ways, mesh),
            _labelled(cfg, state, conv, ways, mesh))


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


def apply_mamba_decode(cfg: ModelConfig, p: Params, cache, x: torch.Tensor,
                       mesh=None):
    """One token: x (B, 1, d) -> (out (B, 1, d), the new cache): the conv
    window rolls by one, the state takes one O(1) update.  The new cache's
    ``conv`` is in the promoted type of the old window and x (as the
    reference's concatenation gives it).  ``mesh``: as
    ``apply_mamba_block``'s, each shard updating its own heads' state and
    window."""
    ways = _ways(p, mesh)
    dm = dims(cfg, ways)

    def heads(p_, conv, s0, x_):
        d_inner, H, G, N, P, _ = dm
        B_ = x_.shape[0]
        z, xBC, dt_raw = _split(dm, x_[:, 0] @ p_["in_proj"])
        wt = torch.promote_types(conv.dtype, xBC.dtype)
        win = torch.cat([conv.to(wt), xBC[:, None, :].to(wt)], dim=1)
        conv_out = torch.einsum("bkc,kc->bc", win.float(),
                                p_["conv_w"].float())
        xBC = F.silu(conv_out + p_["conv_b"].float()).to(x_.dtype)

        x_ssm = xBC[..., :d_inner].reshape(B_, H, P)
        B_ssm = xBC[..., d_inner:d_inner + G * N].reshape(B_, G, N)
        C_ssm = xBC[..., d_inner + G * N:].reshape(B_, G, N)
        dt = F.softplus(dt_raw.float() + p_["dt_bias"])  # (B, H)
        dA = torch.exp(dt * -torch.exp(p_["A_log"]))

        Hg = H // G
        xdt = x_ssm.float() * dt[..., None]
        inc = torch.einsum("bgn,bghp->bghpn", B_ssm.float(),
                           xdt.reshape(B_, G, Hg, P)).reshape(B_, H, P, N)
        state = s0 * dA[..., None, None] + inc
        y = torch.einsum("bgn,bghpn->bghp", C_ssm.float(),
                         state.reshape(B_, G, Hg, P, N)).reshape(B_, H, P)
        y = y + x_ssm.float() * p_["D"][None, :, None]
        return (y.reshape(B_, 1, d_inner).to(x_.dtype), z[:, None, :],
                state, win[:, 1:])

    y, z, state, conv = sharding.smap(heads, p, cache["conv"],
                                      cache["state"], x, mesh=mesh)
    return (_out(cfg, p, y, z, ways, mesh),
            _labelled(cfg, state, conv, ways, mesh))
