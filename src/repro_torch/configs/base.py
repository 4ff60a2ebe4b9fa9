"""Model configuration system.

Every assigned architecture is a ``ModelConfig`` registered under its id
(``--arch <id>``).  Configs are plain frozen dataclasses so they can be
hashed, compared and copied freely.  This is the port's own copy of
``repro.configs.base``: the fields, ``reduced()`` and the registry are the
same, so a config built here describes exactly the model the reference
package builds from the same id.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Shape grid (assigned): every LM arch is exercised under these four shapes.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One (seq_len, global_batch) cell of the assigned shape grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0  # intermediate size of the shared expert (0 = none)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Layers that are dense instead of MoE (e.g. first layer in some models).
    first_dense_layers: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD block hyperparameters (arXiv:2405.21060)."""

    state_size: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    ngroups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: mamba backbone + a shared attention block every N."""

    attn_every: int = 6  # apply the shared attention block every N ssm layers


@dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper: 30s audio -> 1500 frames


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    # Ops / norm variants (paper §2.1: LLMs differ in these).
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    activation: str = "swiglu"  # "swiglu" | "geglu" | "gelu"
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # stablelm2 uses partial rotary (0.25)
    tie_embeddings: bool = False
    qkv_bias: bool = False
    # Sub-family configs.
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    # VLM stub frontend: number of visual patch embeddings prepended.
    num_patches: int = 0
    # KV-cache storage representation: "bf16" (default; alias "fp"), "f8",
    # or the quantized paged layouts "int8" / "fp8".  The port's paged
    # pool serves "bf16"/"fp", "int8" and "fp8"; the engine refuses "f8".
    kv_dtype: str = "bf16"
    # Attention-kernel implementation for BOTH serving hot paths — paged
    # flash-decode (kernels.flash_decode.ops) and paged flash-prefill
    # (kernels.flash_prefill.ops):
    #   "auto" — the CUDA kernels for CUDA tensors, the plain PyTorch
    #            versions for CPU tensors;
    #   "on"   — always the kernels (CPU tensors raise: no interpret mode);
    #   "off"  — always the plain versions, on either device.
    attn_kernel: str = "auto"
    # Which shapes this arch skips (with reason).
    skip_shapes: Tuple[Tuple[str, str], ...] = ()
    # Citation provenance for the config values.
    source: str = ""

    # -- derived -----------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        assert self.family in FAMILIES, self.family
        assert self.kv_dtype in ("fp", "bf16", "f8", "int8", "fp8"), \
            self.kv_dtype
        assert self.attn_kernel in ("auto", "on", "off"), self.attn_kernel
        if self.num_heads and self.num_kv_heads:
            assert self.num_heads % self.num_kv_heads == 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run 500k-token decode (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def shape_supported(self, shape: str) -> Tuple[bool, str]:
        for s, why in self.skip_shapes:
            if s == shape:
                return False, why
        return True, ""

    # -- parameter counting (used by core/ and roofline) --------------------
    def param_count(self) -> int:
        """Exact parameter count of the port's model (from shapes only)."""
        from repro_torch.models import model as _model  # lazy: no torch here

        return _model.param_count(self)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.family == "ssm" or self.family == "hybrid":
            kw["d_ff"] = 128 if self.d_ff else 0
        out = replace(self, **kw)
        if self.moe is not None:
            out = replace(
                out,
                moe=replace(
                    self.moe,
                    num_experts=4,
                    num_experts_per_tok=2,
                    shared_d_ff=64 if self.moe.shared_d_ff else 0,
                    # Smoke configs route ~T/2 tokens per expert; a generous
                    # capacity keeps prefill/decode numerically identical.
                    capacity_factor=4.0,
                ),
            )
        if self.ssm is not None:
            out = replace(
                out, ssm=replace(self.ssm, state_size=16, head_dim=16, chunk_size=32)
            )
        if self.hybrid is not None:
            out = replace(out, hybrid=replace(self.hybrid, attn_every=2))
        if self.encdec is not None:
            out = replace(
                out, encdec=replace(self.encdec, num_encoder_layers=2, encoder_seq_len=16)
            )
        if self.num_patches:
            out = replace(out, num_patches=4)
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    _ensure_imported()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    _ensure_imported()
    return sorted(_REGISTRY)


_IMPORTED = False


def _ensure_imported():
    global _IMPORTED
    if _IMPORTED:
        return
    # Import every config module so registrations run.  The port serves
    # the dense family only so far; its configs land here as they do.
    from repro_torch.configs import tinyllama_1_1b  # noqa: F401

    _IMPORTED = True
