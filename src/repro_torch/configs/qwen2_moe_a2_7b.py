"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

_SKIP = (("long_500k",
          "full-attention MoE: 500k decode requires sub-quadratic attention; "
          "skipped per assignment"),)


@register("qwen2-moe-a2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,  # per-expert intermediate size
        vocab_size=151_936,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=1_000_000.0,
        qkv_bias=True,
        moe=MoEConfig(num_experts=60, num_experts_per_tok=4,
                      num_shared_experts=4, shared_d_ff=5632,
                      capacity_factor=1.25),
        skip_shapes=_SKIP,
        source="hf:Qwen/Qwen1.5-MoE-A2.7B; 24L d=2048 16H 60e top-4 + shared",
    )
