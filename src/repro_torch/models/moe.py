"""Mixture-of-Experts FFN with token-choice top-k routing.

Port of ``repro.models.moe`` (the auto-partitioned path; the reference's
shard_map path needs a mesh, which the port does not serve yet).  Tokens
are dispatched by gather into per-expert capacity buffers: each (token,
k) assignment gets a FIFO slot in its expert's buffer (token-major,
k-minor), assignments past the capacity ``C`` and tokens marked invalid
(pads, dead serving lanes) go to the drop bin and consume no capacity.
The expert SwiGLU FFN runs batched over (group, expert) — plain batched
products, which the reference leaves to XLA — and each token sums its
kept slots' outputs weighted by its renormalised router probabilities.

Groups: the reference dispatches one group per data shard; without a
mesh there is one group, and the group dimension G is kept so that a
sharded slice can set it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

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
    m = cfg.moe
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)  # (T, E)
    weights, experts = torch.topk(probs, m.num_experts_per_tok, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                    min=1e-9)
    me = probs.mean(0)
    ce = F.one_hot(experts[:, 0], m.num_experts).float().mean(0)
    aux = m.num_experts * (me * ce).sum()
    return weights, experts, aux


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
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss).

    valid: optional (B, S) bool — False tokens consume no expert capacity
    and get no expert output (the shared expert still runs on them).
    The capacity counts every row and column of ``x``, pads and dead
    lanes included, as the reference's does."""
    B, S, d = x.shape
    G = 1  # dispatch groups: one per data shard, one without a mesh
    T = B * S // G
    xt = x.reshape(G, T, d)
    C = capacity(cfg, T)

    weights, experts, aux = route(cfg, p["router"], xt.reshape(G * T, d))
    weights = weights.reshape(G, T, -1)
    experts = experts.reshape(G, T, -1)
    slot, buf_tok = _dispatch_indices(
        cfg, experts, C, None if valid is None else valid.reshape(G, T))
    expert_out = _expert_ffn(p, _gather(xt, buf_tok))
    out = _combine(expert_out, experts, slot, weights, C)
    if "shared" in p:
        out = out + apply_shared(cfg, p["shared"], xt.reshape(G * T, d)
                                 ).reshape(G, T, d)
    return out.reshape(B, S, d), aux


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
