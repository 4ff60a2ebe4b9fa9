"""Mixture-of-Experts FFN with token-choice top-k routing.

Port of ``repro.models.moe``: the auto-partitioned path (over a mesh:
``apply_moe(mesh=)``) and the manual-collective path
(``apply_moe_manual``: experts over the data axes, all-to-alls, the
expert FFN sliced on d_model over ``model``).  Tokens are dispatched by
gather into per-expert capacity buffers: each (token, k) assignment gets
a FIFO slot in its expert's buffer (token-major, k-minor), assignments
past the capacity ``C`` and tokens marked invalid (pads, dead serving
lanes) go to the drop bin and consume no capacity.
The expert SwiGLU FFN runs batched over (group, expert) — plain batched
products, which the reference leaves to XLA — and each token sums its
kept slots' outputs weighted by its renormalised router probabilities.

Groups: one dispatch group per data shard (``_num_groups``: the data
axes' size under ``sharding.use_axes`` when it divides B, as in the
reference), so that slot assignment stays local; over a placed mesh each
data shard holds its own group, and the load-balancing loss is formed
from the mean router probabilities and top-1 fractions averaged over the
data shards — the statistics the reference takes over all groups at
once.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.parallel import sharding

Params = Dict[str, Any]


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots per expert for ``num_tokens`` routed tokens: k T / E times
    the capacity factor, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(math.ceil(m.num_experts_per_tok * num_tokens / m.num_experts
                      * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """One layer's MoE leaves, as the reference's ``init_moe`` lays them
    out: the router (d, E) — kept fp32 by ``model.init_params`` — the
    experts (E, d, f) / (E, f, d) with fan-in on axis -2, and the
    shared expert's MLP when ``shared_d_ff`` is set."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.num_experts
    shapes: Dict[str, Any] = {"router": (d, E), "w_gate": (E, d, f),
                              "w_up": (E, d, f), "w_down": (E, f, d)}
    if m.shared_d_ff:
        shapes["shared"] = layers.mlp_shapes(cfg, d_ff=m.shared_d_ff)
    return shapes


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x: (T, d) -> (weights (T, k) fp32, experts (T, k) int64, aux).

    fp32 router logits and softmax, top-k, weights renormalised over the
    k picks, and the Switch load-balancing loss E * sum(mean prob *
    top-1 fraction)."""
    weights, experts, me, ce = _route_stats(cfg, router_w, x)
    return weights, experts, _aux(cfg, me, ce)


def _route_stats(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """``route`` with the load-balancing statistics in place of the loss:
    (weights, experts, mean router probability per expert, top-1
    fraction per expert)."""
    return _route_logits(cfg, x.float() @ router_w.float())


def _route_logits(cfg: ModelConfig, logits: torch.Tensor):
    """``route`` from fp32 logits (T, E): (weights, experts, mean router
    probability per expert, top-1 fraction per expert)."""
    m = cfg.moe
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, m.num_experts_per_tok, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                    min=1e-9)
    ce = F.one_hot(experts[:, 0], m.num_experts).float().mean(0)
    return weights, experts, probs.mean(0), ce


def _aux(cfg: ModelConfig, me: torch.Tensor, ce: torch.Tensor):
    """The Switch load-balancing loss E * sum(me * ce)."""
    return cfg.moe.num_experts * (me * ce).sum()


def _num_groups(B: int, S: int) -> int:
    """Dispatch groups: one per data shard of the active axis state, so
    that slot assignment stays local (1 when they do not divide B)."""
    dp = sharding._axes_size_hint(sharding.data_axes()) or 1
    return dp if B % dp == 0 else 1


def _dispatch_indices(cfg: ModelConfig, experts: torch.Tensor, C: int,
                      valid: Optional[torch.Tensor] = None):
    """Each (group, token, k) assignment's slot in its expert's buffer.

    experts: (G, T, k) int; valid: optional (G, T) bool — False tokens go
    to the drop bin and consume no capacity.  Returns (slot (G, T, k)
    int32 in [0, C], C = dropped; buf_tok (G, E, C) int32, the token of
    each slot, T = empty)."""
    G, T, k = experts.shape
    E = cfg.moe.num_experts
    dev = experts.device
    flat_e = experts.reshape(G, T * k).long()  # token-major, k-minor
    one_hot = F.one_hot(flat_e, E).to(torch.int32)  # (G, T*k, E)
    if valid is not None:
        flat_v = valid.repeat_interleave(k, dim=1)
        one_hot = one_hot * flat_v[..., None].to(torch.int32)
    pos_in_e = torch.cumsum(one_hot, dim=1, dtype=torch.int32) - 1
    slot = torch.take_along_dim(pos_in_e, flat_e[..., None], dim=2)[..., 0]
    slot_c = torch.where(slot < C, slot, C)
    if valid is not None:
        slot_c = torch.where(flat_v, slot_c, C)
    # Column C is the drop bin: written by every dropped assignment, then
    # cut off.
    buf = torch.full((G, E, C + 1), T, dtype=torch.int32, device=dev)
    g_idx = torch.arange(G, device=dev)[:, None].expand_as(flat_e)
    tok = (torch.arange(T * k, device=dev, dtype=torch.int32) // k)[None] \
        .expand_as(flat_e)
    buf[g_idx, flat_e, slot_c.long()] = tok
    return slot_c.reshape(G, T, k), buf[:, :, :C]


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor,
              valid: Optional[torch.Tensor] = None, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss).

    valid: optional (B, S) bool — False tokens consume no expert capacity
    and get no expert output (the shared expert still runs on them).
    The capacity counts every row and column of ``x``, pads and dead
    lanes included, as the reference's does.  Without a mesh the tokens
    are dispatched in ``_num_groups`` groups.

    mesh: ``p``, ``x`` and ``valid`` are ``sharding.Sharded`` trees, each
    data shard's x its rows of the batch, whole over ``model`` (its own
    dispatch group).  Where the manual-collective path applies
    (``expert_parallel``, no mask) it runs (``apply_moe_manual``).  Otherwise the experts are whole over the
    data axes (gathered by the caller, or never cut) and either whole
    over ``model`` or cut on their hidden dim, the router whole: every
    model shard routes and dispatches alike, a ``psum`` follows the down
    projection's partial outputs, combined per token; the shared expert
    is cut as a dense MLP, with its own ``psum``.  The output is equal on
    every model shard, and so is aux; over several data shards aux is
    formed from the router statistics averaged over them (a ``psum``
    over the data axes)."""
    if mesh is None:
        G = _num_groups(x.shape[0], x.shape[1])
        out, me, ce = _routed(cfg, p, x, valid, G)
        out = out if "shared" not in p else out + _shared(cfg, p["shared"],
                                                          x)
        return out, _aux(cfg, me, ce)
    if valid is None and expert_parallel(cfg, mesh, x):
        return apply_moe_manual(cfg, p, x, mesh)
    if any(isinstance(w, sharding.Sharded) and w.rows is not None
           for w in (p["w_gate"], p["w_up"], p["w_down"])):
        raise ValueError("apply_moe over a mesh takes experts whole over "
                         "the data axes (all-gather them first)")
    if sharding.cut_dim(p["w_gate"]) == 1:
        raise NotImplementedError(
            "experts cut on d_model over the model axis run only on the "
            "manual-collective path (manual_path_available)")
    routed = {k: v for k, v in p.items() if k != "shared"}
    out, me, ce = sharding.smap(lambda p_, x_, v_: _routed(cfg, p_, x_, v_),
                                routed, x, valid, mesh=mesh)
    dp = data_shard_axes(mesh)
    if dp:
        n = sharding.axes_size(mesh, dp)
        me, ce = (sharding.smap(lambda a: a / n, sharding.psum(t, dp),
                                mesh=mesh) for t in (me, ce))
    aux = sharding.smap(lambda a, b: _aux(cfg, a, b), me, ce, mesh=mesh)
    if sharding.cut_dim(p["w_down"]) is not None:
        out = sharding.psum(out)
    return _plus_shared(cfg, p, x, out, mesh), aux


def _plus_shared(cfg: ModelConfig, p: Params, x, out, mesh):
    """``out`` plus the shared expert on x over ``mesh``, cut as a dense
    MLP (a ``psum`` after its down projection where that is cut)."""
    if "shared" not in p:
        return out
    sh = sharding.smap(lambda p_, x_: _shared(cfg, p_, x_), p["shared"], x,
                       mesh=mesh)
    if sharding.cut_dim(p["shared"]["w_down"]) is not None:
        sh = sharding.psum(sh)
    return sharding.smap(torch.add, out, sh, mesh=mesh)


def data_shard_axes(mesh) -> Tuple[str, ...]:
    """The data axes of ``mesh`` above size 1: its data shards."""
    st = sharding.AxisState.from_mesh(mesh)
    return tuple(a for a in st.dp if st.size(a) > 1)


def _routed(cfg: ModelConfig, p: Params, x: torch.Tensor,
            valid: Optional[torch.Tensor] = None, G: int = 1):
    """The routed experts' half of ``apply_moe`` in G dispatch groups:
    (out (B, S, d), mean router probability per expert, top-1 fraction
    per expert), the statistics over all B * S tokens."""
    B, S, d = x.shape
    T = B * S // G
    xt = x.reshape(G, T, d)
    C = capacity(cfg, T)

    weights, experts, me, ce = _route_stats(cfg, p["router"],
                                            xt.reshape(G * T, d))
    weights = weights.reshape(G, T, -1)
    experts = experts.reshape(G, T, -1)
    slot, buf_tok = _dispatch_indices(
        cfg, experts, C, None if valid is None else valid.reshape(G, T))
    expert_out = _expert_ffn(p, _gather(xt, buf_tok))
    out = _combine(expert_out, experts, slot, weights, C)
    return out.reshape(B, S, d), me, ce


def _shared(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared expert on every token of x (B, S, d)."""
    return apply_shared(cfg, p, x.reshape(-1, x.shape[-1])).reshape(x.shape)


def _gather(xt: torch.Tensor, buf_tok: torch.Tensor) -> torch.Tensor:
    """The tokens of each expert's slots: xt (G, T, d), buf_tok (G, E, C)
    -> (G, E, C, d), zeros in empty slots."""
    G, T, d = xt.shape
    E, C = buf_tok.shape[1:]
    idx = torch.clamp(buf_tok, max=T - 1).long().reshape(G, E * C, 1)
    return torch.gather(xt, 1, idx.expand(G, E * C, d)) \
        .reshape(G, E, C, d).masked_fill((buf_tok >= T)[..., None], 0)


def _expert_ffn(p: Params, expert_in: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU FFN, batched over (group, expert): (G, E, C,
    d) -> (G, E, C, d)."""
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"])) * \
        torch.einsum("gecd,edf->gecf", expert_in, p["w_up"])
    return torch.einsum("gecf,efd->gecd", h, p["w_down"])


def _combine(expert_out: torch.Tensor, experts: torch.Tensor,
             slot: torch.Tensor, weights: torch.Tensor, C: int
             ) -> torch.Tensor:
    """Each token's kept slots' outputs, weighted in the compute dtype
    and summed: (G, T, d).  The reference scatter-adds the weighted
    slots; this is the same sum written as a gather over the token's k
    slots, so that no two writes meet (no atomics on the card: the same
    bits from run to run)."""
    G, E, _, d = expert_out.shape
    T, k = slot.shape[1:]
    flat = (experts.long() * C + torch.clamp(slot, max=C - 1).long()) \
        .reshape(G, T * k, 1)
    picked = torch.gather(expert_out.reshape(G, E * C, d), 1,
                          flat.expand(G, T * k, d)).reshape(G, T, k, d)
    contrib = (picked * weights.to(expert_out.dtype)[..., None]) \
        .masked_fill((slot >= C)[..., None], 0)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out


def apply_shared(cfg: ModelConfig, p: Params, xt: torch.Tensor
                 ) -> torch.Tensor:
    """The shared expert: an ungated SwiGLU MLP on every token, as in the
    reference."""
    return (F.silu(xt @ p["w_gate"]) * (xt @ p["w_up"])) @ p["w_down"]


def E_total(cfg: ModelConfig) -> int:
    return cfg.moe.num_experts


# ---------------------------------------------------------------------------
# Manual-collective MoE: experts over the data axes, all-to-alls, the expert
# FFN sliced on d_model over ``model``
#
# The auto path over a mesh needs every expert on every data shard; this
# path keeps each expert on one data shard (expert parallelism) and moves
# tokens instead: local top-k -> all_to_all over the expert-parallel axes
# -> the d-sliced expert FFN with ONE psum at hidden volume -> reverse
# all_to_all -> a local combine.  The dispatch payloads are d/tp-sliced,
# so the all-to-alls are not repeated across model shards.
# ---------------------------------------------------------------------------

def _manual_axes():
    st = sharding.axis_state()
    ep = tuple(a for a in ("pod", "data") if st.size(a) > 1)
    tp = st.tp if st.size(st.tp) > 1 else None
    ep_n = 1
    for a in ep:
        ep_n *= st.size(a)
    tp_n = st.size(tp) if tp else 1
    return ep, ep_n, tp, tp_n


def manual_path_available(cfg: ModelConfig, T: int) -> bool:
    """Whether the manual path applies to T tokens under the active axis
    state: data and model axes both above 1, and the experts, T, d_ff
    and d_model dividing them."""
    ep, ep_n, tp, tp_n = _manual_axes()
    m = cfg.moe
    return (ep_n > 1 and tp is not None
            and m.num_experts % ep_n == 0
            and T % ep_n == 0
            and cfg.d_ff % tp_n == 0
            and cfg.d_model % tp_n == 0)


def expert_parallel(cfg: ModelConfig, mesh, x) -> bool:
    """Whether the manual path runs on ``mesh`` for the placed x (each
    data shard's rows of the batch; or its local (B, S)):
    ``manual_path_available`` over the ``data`` and ``model`` axes, the
    axes the train rule cuts the experts over (a ``pod`` axis holds
    replicas of them).  The experts then stay cut (never gathered)."""
    if cfg.moe is None or mesh is None:
        return False
    local = x.parts[0].shape if isinstance(x, sharding.Sharded) else x
    T = local[0] * local[1] * sharding.axes_size(mesh, data_shard_axes(mesh))
    st = sharding.AxisState.from_mesh(mesh)
    with sharding.use_axes(sharding.AxisState(tuple(
            (a, st.size(a)) for a in ("data", sharding.TP_AXIS)))):
        return manual_path_available(cfg, T)


def apply_moe_manual(cfg: ModelConfig, p: Params, x, mesh):
    """x: a ``sharding.Sharded`` (B, S, d) a place — each data shard's
    rows of the batch, whole over ``model`` — -> (out, aux), both equal
    on every model shard.  Requires ``expert_parallel``.

    ``p`` is placed by the train rule's expert-parallel layout: the
    router whole; ``w_gate`` / ``w_up`` (E, d, f) cut on E over the data
    axes and on d over ``model``, ``w_down`` (E, f, d) on E and d.  A
    place (data i, model j) takes its tokens' d-slice j, forms partial
    router logits from the router's rows j and ``psum``s them over
    ``model`` (every model shard then routes alike), dispatches into (E,
    C, d/tp) buffers at capacity C of its own tokens, ``all_to_all``s
    them over the data axes to the experts' owners, runs the partial
    up-projections, ``psum``s them over ``model`` (hidden volume), the
    exact d-sliced down projection, ``all_to_all``s back and combines
    locally; an ``all_gather`` over ``model`` rebuilds d (the reference
    leaves its output d-sharded).  The all-to-alls run over ``data``, the
    axis the experts are cut over: where a ``pod`` axis holds replicas of
    them, each pod exchanges among its own data shards (the reference's
    shard_map reshards them over pod x data).  aux is each data shard's
    loss, its mean over every place (``psum`` / n).  The shared expert runs as in
    ``apply_moe``."""
    m = cfg.moe
    tp, ep = sharding.TP_AXIS, ("data",)
    ep_n, tp_n = sharding.axes_size(mesh, ep), sharding.axes_size(mesh, tp)
    E, d, n = m.num_experts, cfg.d_model, mesh.devices.size
    d_loc = d // tp_n
    B, S = x.parts[0].shape[:2]
    T_loc = B * S
    C = capacity(cfg, T_loc)
    mi = sharding.axis_index(mesh, tp)
    cols = [slice(j * d_loc, (j + 1) * d_loc) for j in mi]
    xt = [x.parts[k].reshape(T_loc, d)[:, cols[k]] for k in range(n)]
    logits = sharding.psum(x.with_parts(
        [xt[k].float() @ p["router"].parts[k][cols[k]].float()
         for k in range(n)]), tp)
    routed = [_route_logits(cfg, lg) for lg in logits.parts]
    disp = [_dispatch_indices(cfg, r[1][None], C) for r in routed]
    expert_in = x.with_parts([_gather(xt[k][None], disp[k][1])[0]
                              for k in range(n)])
    expert_in = sharding.all_to_all(expert_in, ep, 0, 1)  # (E/ep, C ep, d/tp)
    g_part, u_part = (x.with_parts([torch.einsum(
        "ecd,edf->ecf", e, w) for e, w in zip(expert_in.parts,
                                              p[name].parts)])
        for name in ("w_gate", "w_up"))
    h = [F.silu(g) * u for g, u in zip(sharding.psum(g_part, tp).parts,
                                       sharding.psum(u_part, tp).parts)]
    y = sharding.all_to_all(x.with_parts([torch.einsum(
        "ecf,efd->ecd", h_, w) for h_, w in zip(h, p["w_down"].parts)]),
        ep, 1, 0)  # (E, C, d/tp)
    out = sharding.Sharded(tuple(
        _combine(y.parts[k][None], routed[k][1][None], disp[k][0],
                 routed[k][0][None], C)[0].reshape(B, S, d_loc)
        for k in range(n)), 2, mesh)
    out = sharding.all_gather(out)
    aux = sharding.psum(x.with_parts([_aux(cfg, r[2], r[3])
                                      for r in routed]),
                        data_shard_axes(mesh) + (tp,))
    aux = sharding.smap(lambda a: a / n, aux, mesh=mesh)
    return _plus_shared(cfg, p, x, out, mesh), aux
