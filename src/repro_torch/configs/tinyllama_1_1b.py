"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385]."""
from repro_torch.configs.base import ModelConfig, register

_SKIP = (("long_500k",
          "pure full-attention arch: 500k decode requires sub-quadratic "
          "attention; skipped per assignment"),)


@register("tinyllama-1.1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_ff=5632,
        vocab_size=32_000,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=10_000.0,
        skip_shapes=_SKIP,
        source="arXiv:2401.02385; 22L d=2048 32H GQA(kv=4)",
    )
