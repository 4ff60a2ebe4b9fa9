"""LLM workload descriptions for the co-design engine (paper Table 2 models).

These are the paper's eight case-study models plus our ten assigned
architectures, described by the hyperparameters the analytic
inference simulator needs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class LLMWorkload:
    name: str
    d_model: int
    num_layers: int
    num_heads: int
    kv_heads: int  # == num_heads for MHA, 1 for MQA, groups for GQA
    d_ff: int
    vocab: int
    params: float  # total parameter count
    # MoE (active expert params already folded into `params_active`).
    params_active: Optional[float] = None
    # SCLD: stored-bytes / dense-bytes for the weights (core.sparsity).
    weight_storage_factor: float = 1.0

    @property
    def active(self) -> float:
        return self.params_active or self.params

    def kv_bytes_per_token(self, bytes_per=2) -> float:
        """KV-cache bytes appended per generated token (whole model)."""
        head_dim = self.d_model // self.num_heads
        return 2 * self.num_layers * self.kv_heads * head_dim * bytes_per

    def flops_per_token(self, ctx: int) -> float:
        """Decode FLOPs per generated token at context length ctx."""
        dense = 2.0 * self.active
        attn = 4.0 * self.num_layers * ctx * self.d_model
        return dense + attn


def _ff(d, mult=4):
    return d * mult


# Paper Table 2 rows (public hyperparameters).
PAPER_MODELS: Dict[str, LLMWorkload] = {
    "gpt2-1.5b": LLMWorkload("gpt2-1.5b", 1600, 48, 25, 25, _ff(1600), 50257,
                             1.5e9),
    "megatron-8.3b": LLMWorkload("megatron-8.3b", 3072, 72, 32, 32, _ff(3072),
                                 51200, 8.3e9),
    "gpt3-175b": LLMWorkload("gpt3-175b", 12288, 96, 96, 96, _ff(12288),
                             50257, 175e9),
    "gopher-280b": LLMWorkload("gopher-280b", 16384, 80, 128, 128, _ff(16384),
                               32000, 280e9),
    "mt-nlg-530b": LLMWorkload("mt-nlg-530b", 20480, 105, 128, 128,
                               _ff(20480), 50257, 530e9),
    "bloom-176b": LLMWorkload("bloom-176b", 14336, 70, 112, 112, _ff(14336),
                              250880, 176e9),
    # PaLM: multi-query attention (kv_heads=1), ff mult 4.
    "palm-540b": LLMWorkload("palm-540b", 18432, 118, 48, 1, _ff(18432),
                             256000, 540e9),
    # Llama-2 70B: GQA with 8 kv heads, SwiGLU ff 28672.
    "llama2-70b": LLMWorkload("llama2-70b", 8192, 80, 64, 8, 28672, 32000,
                              70e9),
}

