"""phi3-medium-14b — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.configs.base import ModelConfig, register

_SKIP = (("long_500k",
          "pure full-attention arch: 500k decode requires sub-quadratic "
          "attention; skipped per assignment"),)


@register("phi3-medium-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        d_ff=17_920,
        vocab_size=100_352,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=10_000.0,
        skip_shapes=_SKIP,
        source="arXiv:2404.14219; 40L d=5120 40H GQA(kv=10) d_ff=17920",
    )
