"""Mixture-of-Experts FFN with token-choice top-k routing.

Port of ``repro.models.moe``: the auto-partitioned path (over a mesh:
``apply_moe(mesh=)``), the manual-collective path (``apply_moe_manual``:
experts over the data axes, all-to-alls, the expert FFN sliced on
d_model over ``model``) and the grouped path over a mesh (``_grouped``:
the reference's dispatch groups on experts kept cut over the data axes
— every serving call, under the serving mask, and training off the
manual path).  Tokens are dispatched by
gather into per-expert capacity buffers: each (token, k) assignment gets
a FIFO slot in its expert's buffer (token-major, k-minor), assignments
past the capacity ``C`` and tokens marked invalid (pads, dead serving
lanes) go to the drop bin and consume no capacity.
The expert SwiGLU FFN runs batched over (group, expert) — plain batched
products, which the reference leaves to XLA — and each token sums its
kept slots' outputs weighted by its renormalised router probabilities.

Groups: one dispatch group per data shard (``_num_groups``: the data
axes' size under ``sharding.use_axes`` when it divides B, as in the
reference) — contiguous rows of the call, each with its own capacity
and slot order.  In training over a placed mesh each data shard holds
its own group where the batch divides the data axes, and the
load-balancing loss is formed from the mean router probabilities and
top-1 fractions averaged over the data shards — the statistics the
reference takes over all groups at once; where it does not, every data
place holds the whole batch, one group, as the reference keeps it
(``sanitize_specs``).  In serving the data places hold rows by lane
slot, which need not be the groups' rows: ``_grouped`` forms each
assignment's slot in its group whichever place holds the row
(``sharding.dispatch_groups``).
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
              valid: Optional[torch.Tensor] = None, mesh=None,
              rows: Optional[sharding.CallRows] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss).

    valid: optional (B, S) bool — False tokens consume no expert capacity
    and get no expert output (the shared expert still runs on them).
    The capacity counts every row and column of ``x``, pads and dead
    lanes included, as the reference's does.  Without a mesh the tokens
    are dispatched in ``_num_groups`` groups.  rows: a serving call's
    ``sharding.CallRows`` — the groups are formed on the reference's
    batch, which holds x's rows at ``rows.at`` (a verify pass's live
    lanes among all lanes) and empty rows elsewhere.

    mesh: ``p``, ``x`` and ``valid`` are ``sharding.Sharded`` trees, x
    whole over ``model``; ``rows`` says which rows each data place holds
    (``rows.split``; every row where it is None, none where a place
    holds no lane) and which call it is.

    A serving call (``rows`` not ``train``): the experts placed by
    ``sharding.serve_specs``, the values the reference's grouped
    dispatch (``_routed`` with ``dispatch_groups``' groups) through
    ``_grouped``, and aux None (serving drops it).

    Training (``rows.train``; None: ``sharding.train_rows`` of x's
    global batch, ``sharding.global_batch``: x's placement, cut on its
    rows or whole, and the call raises where the placement shows an
    ``smap`` result's rows, one place's): each data shard's rows of the
    batch where the batch divides the data axes (its own dispatch
    group), else every row on every data place (one group).  Where the
    manual-collective path applies (``expert_parallel``, no mask) it
    runs (``apply_moe_manual``).  Experts kept cut on E over the data axes
    or on d over ``model`` (never gathered: off the manual path, its
    layout of E / d experts' d / m slice a place) run through
    ``_grouped``: each place forms its group's slots, its own experts'
    slots are computed where they lie.  Otherwise the experts are whole
    over the data axes (gathered by the caller, or never cut) and either
    whole over ``model`` or cut on their hidden dim, the router whole:
    every model shard routes and dispatches alike, a ``psum`` follows
    the down projection's partial outputs, combined per token; the
    shared expert is cut as a dense MLP, with its own ``psum``.  The
    output is equal on every model shard, and so is aux: the
    load-balancing loss of the reference's statistics over every token
    (``_load_loss``)."""
    if mesh is None:
        B, S = x.shape[:2]
        xb, vb = x, valid
        if rows is not None and not rows.identity:
            at = torch.tensor(rows.at, device=x.device)
            xb = _to_slab(x, at, rows.size, 0)
            vb = _to_slab(torch.ones(B, S, dtype=torch.bool, device=x.device)
                          if valid is None else valid, at, rows.size, False)
        out, me, ce = _routed(cfg, p, xb, vb, _num_groups(xb.shape[0], S))
        if xb is not x:
            out = out[at]
        out = out if "shared" not in p else out + _shared(cfg, p["shared"],
                                                          x)
        return out, _aux(cfg, me, ce)
    if rows is None:  # raises where x's global batch cannot be read
        rows = sharding.train_rows(mesh, sharding.global_batch(x, mesh))
    if not rows.train:
        return _grouped(cfg, p, x, valid, mesh, rows)[0], None
    if valid is None and expert_parallel(cfg, mesh, (rows.size, x.shape[1])):
        return apply_moe_manual(cfg, p, x, mesh, rows)
    if any(expert_cuts(p["w_gate"])):
        out, me, ce = _grouped(cfg, p, x, valid, mesh, rows)
    else:
        routed = {k: v for k, v in p.items() if k != "shared"}
        out, me, ce = sharding.smap(
            lambda p_, x_, v_: _routed(cfg, p_, x_, v_), routed, x, valid,
            mesh=mesh)
        if sharding.cut_dim(p["w_down"]) is not None:
            out = sharding.psum(out)
        out = _plus_shared(cfg, p, x, out, mesh)
    return out, _load_loss(cfg, me, ce, mesh, rows)


def _load_loss(cfg: ModelConfig, me, ce, mesh, rows: sharding.CallRows):
    """aux on every place from each place's router statistics (mean
    probability and top-1 fraction per expert over its rows): where the
    data places hold their own rows, the statistics' mean over them (a
    ``psum`` over the data axes), the reference's over every token;
    where each holds the whole batch, its own."""
    dp = data_shard_axes(mesh) if rows.split is not None else ()
    if dp:
        n = sharding.axes_size(mesh, dp)
        me, ce = (sharding.smap(lambda a: a / n, sharding.psum(t, dp),
                                mesh=mesh) for t in (me, ce))
    return sharding.smap(lambda a, b: _aux(cfg, a, b), me, ce, mesh=mesh)


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
             slot: torch.Tensor, weights: torch.Tensor, C: int,
             grp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each token's kept slots' outputs, weighted in the compute dtype
    and summed: expert_out (G, E, C, d); experts / slot / weights the
    tokens' (..., k) choices, slots and weights; grp each token's group
    (broadcast over the token dims; None: tokens (G, T, k), group g's in
    row g).  The reference scatter-adds the weighted slots; this is the
    same sum written as a gather over the token's k slots, so that no two
    writes meet (no atomics on the card: the same bits from run to
    run)."""
    G, E, _, d = expert_out.shape
    if grp is None:
        grp = torch.arange(G, device=slot.device)[:, None]
    flat = (grp.long()[..., None] * E + experts.long()) * C \
        + torch.clamp(slot, max=C - 1).long()
    picked = expert_out.reshape(G * E * C, d)[flat]
    contrib = (picked * weights.to(expert_out.dtype)[..., None]) \
        .masked_fill((slot >= C)[..., None], 0)
    out = contrib[..., 0, :]
    for j in range(1, contrib.shape[-2]):
        out = out + contrib[..., j, :]
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
    """Whether the manual path runs on ``mesh`` for a training batch of
    global (B, S) ``x`` (a tuple, or a ``Sharded`` placed by
    ``sharding.place_batch``) placed as ``place_batch`` places it.  Where
    B divides the data axes: ``manual_path_available`` over the ``data``
    and ``model`` axes, the axes the train rule cuts the experts over (a
    ``pod`` axis holds replicas of them; each data shard's tokens are its
    own group either way).  Where it does not (the batch whole on every
    data place): over every axis of the mesh, as the reference decides
    it, since the token slices then are the reference's groups."""
    if cfg.moe is None or mesh is None:
        return False
    B, S = tuple(x.shape[:2]) if isinstance(x, sharding.Sharded) else x
    st = sharding.AxisState.from_mesh(mesh)
    if B % sharding.data_size(mesh) == 0:
        st = sharding.AxisState(tuple((a, st.size(a))
                                      for a in ("data", sharding.TP_AXIS)))
    with sharding.use_axes(st):
        return manual_path_available(cfg, B * S)


def expert_cuts(w, mesh=None) -> Tuple[bool, bool]:
    """How the routed experts lie, read from ``w_gate`` ((E, d, f), or
    stacked (L, E, d, f)) placed (a ``Sharded``; a plain tensor lies
    whole) or from its spec on ``mesh``: (cut on d_model over ``model``,
    cut on E over the data axes).  The first is the manual path's
    layout, which the train rule gives the experts beside their E cut
    where E divides the data axes: training keeps such experts cut, never
    gathered over the data axes (``model.backbone``).  A layer that
    meets its experts cut either way (``apply_moe`` called on them as
    placed) runs ``_grouped`` off the manual path."""
    if isinstance(w, torch.Tensor):
        return False, False
    if isinstance(w, sharding.Sharded):
        return w.dim == len(w.shape) - 2, w.rows is not None
    dim, rows = sharding._cuts(w, mesh)
    return dim == len(w) - 2, rows is not None


def _token_slices(x, mesh, whole: bool):
    """Each place's routed tokens of x (B, S, d) a place, flattened to
    (T', d): all B S of them, or, where the batch is ``whole`` on every
    data place, its contiguous T / R of them by its index over the R
    data places, as the reference's ``P(ep, tp)`` cuts the flattened
    tokens.  A local slice: its transpose pads the place's own cotangent
    with zeros (no collective: each data place's replicated computation
    carries its own share of the gradient)."""
    B, S, d = x.parts[0].shape
    T = B * S
    if not whole:
        return [t.reshape(T, d) for t in x.parts]
    dp = data_shard_axes(mesh)
    n = T // sharding.axes_size(mesh, dp)
    return [t.reshape(T, d)[i * n:(i + 1) * n]
            for t, i in zip(x.parts, sharding.axis_index(mesh, dp))]


def apply_moe_manual(cfg: ModelConfig, p: Params, x, mesh,
                     rows: sharding.CallRows):
    """x: a ``sharding.Sharded`` (B, S, d) a place, whole over ``model``:
    each data shard's rows of the batch, or, where ``rows.split`` is
    None, the whole batch on every data place -> (out, aux), both equal
    on every model shard.  Requires ``expert_parallel``.

    ``p`` is placed by the train rule's expert-parallel layout: the
    router whole; ``w_gate`` / ``w_up`` (E, d, f) cut on E over the data
    axes and on d over ``model``, ``w_down`` (E, f, d) on E and d.  A
    place (data i, model j) takes its tokens (``_token_slices``: a whole
    batch's slice i of T / R) and their d-slice j, forms partial router
    logits from the router's rows j and ``psum``s them over ``model``
    (every model shard then routes alike), dispatches into (1, E, C,
    d/tp) buffers at capacity C of its own tokens and runs them through
    ``_exchange`` (``all_to_all`` over the data axes to the experts'
    owners, the partial up-projections ``psum``'d over ``model`` at
    hidden volume, the exact d-sliced down projection, the reverse
    ``all_to_all``), combines locally; a whole batch's token slices are
    then ``all_gather``'d over the data axes, and an ``all_gather`` over
    ``model`` rebuilds d (the reference leaves its output cut on both).
    The all-to-alls run over ``data``, the axis the experts are cut
    over: where a ``pod`` axis holds replicas of them, each pod
    exchanges among its own data shards (the reference's shard_map
    reshards them over pod x data).  aux is each place's loss on its
    tokens, its mean over every place (``psum`` / n, the reference's
    ``pmean``).  The shared expert runs as in ``apply_moe``."""
    tp = sharding.TP_AXIS
    tp_n = sharding.axes_size(mesh, tp)
    d, n = cfg.d_model, mesh.devices.size
    d_loc = d // tp_n
    B, S = x.parts[0].shape[:2]
    whole = rows.split is None
    mi = sharding.axis_index(mesh, tp)
    cols = [slice(j * d_loc, (j + 1) * d_loc) for j in mi]
    xt = [t[:, c] for t, c in zip(_token_slices(x, mesh, whole), cols)]
    C = capacity(cfg, xt[0].shape[0])
    logits = sharding.psum(x.with_parts(
        [xt[k].float() @ p["router"].parts[k][cols[k]].float()
         for k in range(n)]), tp)
    routed = [_route_logits(cfg, lg) for lg in logits.parts]
    disp = [_dispatch_indices(cfg, r[1][None], C) for r in routed]
    y = _exchange(p, x.with_parts([_gather(xt[k][None], disp[k][1])
                                   for k in range(n)]), mesh, "local")
    out = sharding.Sharded(tuple(
        _combine(y.parts[k], routed[k][1][None], disp[k][0],
                 routed[k][0][None], C)[0] for k in range(n)), 1, mesh)
    if whole:
        out = sharding.all_gather(out, 0, data_shard_axes(mesh))
    out = sharding.all_gather(sharding.Sharded(tuple(
        t.reshape(B, S, d_loc) for t in out.parts), 2, mesh))
    aux = sharding.psum(x.with_parts([_aux(cfg, r[2], r[3])
                                      for r in routed]),
                        data_shard_axes(mesh) + (tp,))
    aux = sharding.smap(lambda a: a / n, aux, mesh=mesh)
    return _plus_shared(cfg, p, x, out, mesh), aux


def _expert_axes(p: Params) -> Tuple[str, ...]:
    """The axes the routed experts are cut over on E (expert
    parallelism), () where they are whole over the data axes."""
    w = p["w_gate"]
    return w.rows[0] if isinstance(w, sharding.Sharded) and w.rows else ()


def _exchange(p: Params, xin, mesh, how: str):
    """The experts' outputs for every place's dispatch buffer ``xin`` (a
    ``Sharded``, (G, E, C, d') a place, d' its d slice where the experts
    are cut on d over ``model``), (G, E, C, d') a place.  Where the
    experts are cut on E over the data axes, ``how`` says what a buffer
    holds:

      * "local": its own group (that of its data index), cut on E and
        sent to the experts' owners by an ``all_to_all`` that stacks the
        sources' groups on C, and brought back by the reverse
        ``all_to_all``;
      * "tokens": its own tokens' slots of every group, zeros elsewhere,
        cut on E and summed at the owner over the sources (no slot is
        filled twice);
      * "experts": every group's slots of the place's own E / d experts
        (G, E / d, C, d'), run where they are.

    After "tokens" and "experts" the outputs are ``all_gather``'d over
    the data axes.  Experts whole over data: the FFN on each place's
    buffer."""
    ep = _expert_axes(p)
    if ep and how == "local":
        y = _ffn_placed(p, sharding.all_to_all(xin, ep, 1, 2), mesh)
        return sharding.all_to_all(y, ep, 2, 1)
    if ep and how == "tokens":
        G = xin.parts[0].shape[0]
        xin = sharding.all_to_all(xin, ep, 1, 0)
        xin = xin.with_parts([t.reshape((-1, G) + tuple(t.shape[1:]))
                              .sum(0) for t in xin.parts])
    y = _ffn_placed(p, xin, mesh)
    return sharding.all_gather(y, 1, ep) if ep else y


def _ffn_placed(p: Params, xin, mesh):
    """``_expert_ffn`` on each place's buffer with its parts of the
    experts.  Where ``w_gate`` / ``w_up`` are cut on d over ``model`` the
    up projections' partials are ``psum``'d over ``model`` (hidden
    volume) and the down projection is exact on the place's d slice;
    where they are cut on f the outputs are partial (summed by the
    caller)."""
    if sharding.cut_dim(p["w_gate"]) != 1:
        experts = {k: p[k] for k in ("w_gate", "w_up", "w_down")}
        return sharding.smap(_expert_ffn, experts, xin, mesh=mesh)
    g, u = (sharding.psum(xin.with_parts([
        torch.einsum("gecd,edf->gecf", e, w)
        for e, w in zip(xin.parts, p[name].parts)]))
        for name in ("w_gate", "w_up"))
    return xin.with_parts([
        torch.einsum("gecf,efd->gecd", F.silu(a) * b, w)
        for a, b, w in zip(g.parts, u.parts, p["w_down"].parts)])


# ---------------------------------------------------------------------------
# The grouped path over a (data, model) mesh: the reference's groups on the
# placed experts
#
# The reference serves MoE with a validity mask, so it never takes the
# manual path: it dispatches in ``_num_groups`` groups of contiguous rows
# of the call, each with its own capacity and FIFO slot order, whatever
# lanes the rows serve.  The port's data places hold rows by lane slot,
# which for a prefill cohort need not be the groups' rows.  In training
# off the manual path (a batch whose tokens do not divide the data axes,
# or a mask) the reference's GSPMD keeps the experts cut on E over data
# and on d over ``model``, one group where the batch is whole over data.
# ---------------------------------------------------------------------------

def _grouped(cfg: ModelConfig, p: Params, x, valid, mesh,
             rows: sharding.CallRows):
    """``apply_moe`` over ``mesh`` off the manual path, on experts cut
    over the data axes or on d over ``model``: (out, each place's mean
    router probability per expert over its rows, its top-1 fraction per
    expert).  The values of ``_routed`` on the reference's batch
    (``rows``) in ``sharding.dispatch_groups``' groups, on the experts
    as placed (``sharding.serve_specs``, or the train rule's layout kept
    cut).  Each place routes its own rows (the router
    whole, fp32 logits: per token, no collective) and each assignment
    takes its group's slot, FIFO over the group's (row, position, k),
    pads, dead lanes and the batch's empty rows consuming no capacity:

      * local — every data place's rows lie in the group of its data
        index (a decode step, a wave, a verify pass; a cohort so laid
        out): each forms its group's slots alone;
      * gathered — a group's rows lie on other places (a prefill cohort
        whose lanes share a data place): the routing choices (int32,
        invalid tokens marked) are all-gathered over the data axes and
        every place forms every group's slots, then dispatches its own
        rows' kept assignments;
      * replicated — every place holds every row (``rows.split`` None):
        each forms every group's slots from its rows, and where the
        experts are cut on E takes only its experts' slots.

    The buffers then go through ``_exchange``; each place combines its
    rows' tokens in k order and, where the experts are cut on d over
    ``model``, ``all_gather``s d; where they are cut on f the partial
    outputs are ``psum``'d.  The shared expert runs as in ``apply_moe``.
    A place without rows returns None (and no statistics)."""
    m = cfg.moe
    E, k, D = m.num_experts, m.num_experts_per_tok, cfg.d_model
    n_pl = mesh.devices.size
    devs = sharding.grid_devices(mesh)
    di = sharding.axis_index(mesh, sharding.AxisState.from_mesh(mesh).dp)
    d = sharding.data_size(mesh)
    grp = sharding.dispatch_groups(rows, d)
    S = x.shape[1]
    T = grp.per * S
    C = capacity(cfg, T)
    split = rows.split
    held = [tuple(range(rows.n)) if split is None else split.rows[i]
            for i in di]
    local = sharding.groups_on_places(rows, grp)
    ep = _expert_axes(p)
    E_loc = E // sharding.axes_size(mesh, ep)
    ei = sharding.axis_index(mesh, ep) if ep else (0,) * n_pl
    tp_n = sharding.axes_size(mesh, sharding.TP_AXIS)
    d_cut = sharding.cut_dim(p["w_gate"]) == 1
    d_c = D // tp_n if d_cut else D
    mi = sharding.axis_index(mesh, sharding.TP_AXIS)
    xs = [x.parts[q] if x.parts[q] is None or not d_cut
          else x.parts[q][..., mi[q] * d_c:(mi[q] + 1) * d_c]
          for q in range(n_pl)]
    ref = next(t for t in xs if t is not None)
    # Batch rows of each place's rows: within its group (local), or in
    # the whole batch.
    at = [torch.tensor([grp.pos[j] if local else rows.at[j] for j in h],
                       dtype=torch.long, device=devs[q])
          for q, h in enumerate(held)]
    Gs, slab = (1, grp.per) if local else (grp.count, rows.size)

    choices, stats = [None] * n_pl, [(None, None)] * n_pl
    for q in range(n_pl):
        if xs[q] is None:
            continue
        r = x.parts[q].shape[0]
        w_, e_, me, ce = _route_stats(cfg, sharding.local(p["router"], q),
                                      x.parts[q].reshape(r * S, D))
        stats[q] = (me, ce)
        v_ = torch.ones(r, S, dtype=torch.bool, device=devs[q]) \
            if valid is None else valid.parts[q].reshape(r, S)
        choices[q] = (w_.reshape(r, S, k), e_.reshape(r, S, k), v_)

    codes = None
    if not local and split is not None:
        # Invalid tokens' choices marked by E added: one int32 tensor.
        codes = sharding.all_gather(sharding.Sharded(tuple(
            torch.empty((0, S, k), dtype=torch.int32, device=devs[q])
            if c is None else (c[1] + E * (~c[2])[..., None]).to(torch.int32)
            for q, c in enumerate(choices)), None, mesh), 0,
            sharding.AxisState.from_mesh(mesh).dp).parts
        order = torch.tensor([rows.at[j] for r in split.rows for j in r],
                             dtype=torch.long)

    slots, xin = [None] * n_pl, []
    for q in range(n_pl):
        if choices[q] is None:  # no rows: every slot of its buffer empty
            xin.append(torch.zeros((Gs, E, C, d_c), dtype=ref.dtype,
                                   device=devs[q]))
            continue
        if codes is not None:
            full = torch.full((slab, S, k), E, dtype=torch.int32,
                              device=devs[q])
            full[order.to(devs[q])] = codes[q]
            e_b, v_b = full % E, full[..., 0] < E
        else:
            _, e_, v_ = choices[q]
            e_b = _to_slab(e_, at[q], slab, 0)
            v_b = _to_slab(v_, at[q], slab, False)
        slot, buf = _dispatch_indices(cfg, e_b.reshape(Gs, T, k), C,
                                      v_b.reshape(Gs, T))
        slots[q] = slot.reshape(slab, S, k)[at[q]]
        if codes is not None:
            xin.append(_own_tokens(xs[q], buf, at[q], grp.per, S, slab))
            continue
        if ep and not local:
            buf = buf[:, ei[q] * E_loc:(ei[q] + 1) * E_loc]
        xin.append(_gather(_to_slab(xs[q], at[q], slab, 0)
                           .reshape(Gs, T, d_c), buf))
    y = _exchange(p, sharding.Sharded(tuple(xin), None, mesh), mesh,
                  "local" if local else "tokens" if codes is not None
                  else "experts")

    out = []
    for q in range(n_pl):
        if choices[q] is None:
            out.append(None)
            continue
        w_, e_, _ = choices[q]
        g_ = torch.zeros_like(at[q]) if local else at[q] // grp.per
        out.append(_combine(y.parts[q], e_, slots[q], w_, C, g_[:, None]))
    out = sharding.Sharded(tuple(out), 2 if d_cut and tp_n > 1 else None,
                           mesh)
    if d_cut:
        out = sharding.all_gather(out)
    elif sharding.cut_dim(p["w_down"]) is not None:
        out = sharding.psum(out)
    me, ce = (sharding.Sharded(tuple(t), None, mesh) for t in zip(*stats))
    return _plus_shared(cfg, p, x, out, mesh), me, ce


def _to_slab(t: torch.Tensor, at: torch.Tensor, n: int, fill
             ) -> torch.Tensor:
    """Rows ``t`` at rows ``at`` of n rows filled with ``fill`` (a call's
    rows in the reference's batch, or in one group of it)."""
    out = torch.full((n,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                     device=t.device)
    out[at] = t
    return out


def _own_tokens(xq: torch.Tensor, buf: torch.Tensor, at: torch.Tensor,
                per: int, S: int, size: int) -> torch.Tensor:
    """A place's dispatch buffer of every group's slots (G, E, C, d'):
    the tokens of its own rows ``xq`` (batch rows ``at``) in their slots,
    zeros in the others'; buf (G, E, C) each slot's token in its group of
    ``per`` rows of S positions (per S: empty)."""
    G = buf.shape[0]
    T = per * S
    t = torch.clamp(buf.long(), max=T - 1)
    lmap = torch.full((size,), -1, dtype=torch.long, device=xq.device)
    lmap[at] = torch.arange(at.numel(), device=xq.device)
    li = lmap[torch.arange(G, device=xq.device)[:, None, None] * per
              + t // S]
    keep = (buf < T) & (li >= 0)
    return xq[li.clamp(min=0), t % S].masked_fill(~keep[..., None], 0)
