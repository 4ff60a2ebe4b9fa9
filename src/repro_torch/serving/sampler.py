"""Token samplers: greedy, temperature, top-k.

Port of ``repro.serving.sampler``.  JAX's ``fold_in``/threefry keys have
no PyTorch counterpart, so stochastic sampling uses a counter-based rule
computed on the device: a 32-bit integer hash of (seed, uid) is a
request's key, the hash of (key, position) is the key of its token at
that position, and the hash of (token key, vocab index) gives one uniform
per vocab entry, turned into Gumbel noise; the sample is
``argmax(logits / temperature + gumbel)``.  A request's token at position
p is therefore a pure function of (seed, uid, p, logits): independent of
co-tenants and the same after a preemption recompute, as in the
reference.  The bits differ from JAX's; greedy sampling is the
cross-framework comparison.

The hash is murmur3's 32-bit finalizer over int64 tensors, with every
product split so no intermediate leaves [0, 2**63): the same bits on the
CPU and on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no truncation


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Hash each 32-bit key with a data word: int64 tensors holding values
    in [0, 2**32) (broadcasting), -> int64 keys in [0, 2**32)."""
    h = _fmix32((keys & _M32) ^ 0x9E3779B9)
    return _fmix32(_mul32(h, 0x01000193) ^ (data.to(torch.int64) & _M32))


def request_keys(seed: int, uids: torch.Tensor) -> torch.Tensor:
    """Per-request base keys: fold_in(seed, uid); uids (B,) -> (B,) int64."""
    uids = uids.to(torch.int64)
    return fold_in(torch.full_like(uids, seed & _M32), uids)


def positional_keys(keys: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Row b's token at position p samples with fold_in(keys[b], p)."""
    return fold_in(keys, positions)


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B,) keys -> (B, vocab) fp32 Gumbel noise, one hash per entry."""
    idx = torch.arange(vocab, device=keys.device, dtype=torch.int64)
    bits = fold_in(keys[:, None], idx[None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    return -torch.log(-torch.log(u))


def sample(cfg: SamplerConfig, logits: torch.Tensor,
           keys: Optional[torch.Tensor] = None,
           active: Optional[torch.Tensor] = None,
           pad_id: int = 0) -> torch.Tensor:
    """logits: (B, V) -> token ids (B,) int32.

    ``keys``: (B,) per-row keys (``positional_keys``), needed when
    ``cfg.temperature > 0``.  ``active``: optional (B,) bool mask — rows
    where it is False emit ``pad_id``.  Greedy is ``argmax``, which
    returns the first maximal index, as ``jnp.argmax`` does.
    """
    if cfg.temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        if keys is None:
            raise ValueError("stochastic sampling needs per-row keys")
        lg = logits.float() / cfg.temperature
        if cfg.top_k > 0:
            kth = torch.topk(lg, cfg.top_k, dim=-1).values[..., -1:]
            lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
        g = gumbel_noise(keys, lg.shape[-1])
        tok = torch.argmax(lg + g, dim=-1).to(torch.int32)
    if active is not None:
        tok = torch.where(active, tok, torch.full_like(tok, pad_id))
    return tok
