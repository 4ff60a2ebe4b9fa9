"""stablelm-1.6b — [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig, register

_SKIP = (("long_500k",
          "pure full-attention arch: 500k decode requires sub-quadratic "
          "attention; skipped per assignment"),)


@register("stablelm-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=5632,
        vocab_size=100_352,
        norm="layernorm",
        activation="swiglu",
        rope_theta=10_000.0,
        rope_fraction=0.25,  # stablelm-2 partial rotary
        skip_shapes=_SKIP,
        source="hf:stabilityai/stablelm-2-1_6b; 24L d=2048 32H MHA",
    )
