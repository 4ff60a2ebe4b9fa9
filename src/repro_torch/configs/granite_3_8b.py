"""granite-3-8b — GQA [hf:ibm-granite/granite-3.0 family]."""
from repro_torch.configs.base import ModelConfig, register

_SKIP = (("long_500k",
          "pure full-attention arch: 500k decode requires sub-quadratic "
          "attention; skipped per assignment"),)


@register("granite-3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12_800,
        vocab_size=49_155,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        skip_shapes=_SKIP,
        source="hf:ibm-granite/granite-3.0-8b-base; 40L d=4096 32H GQA(kv=8)",
    )
