"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

_SKIP = (("long_500k",
          "full-attention MoE: 500k single-token decode requires sub-quadratic "
          "attention; skipped per assignment"),)


@register("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,  # qwen3 uses head_dim=128 (not d_model/num_heads)
        d_ff=1536,  # per-expert intermediate size
        vocab_size=151_936,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=1_000_000.0,
        moe=MoEConfig(num_experts=128, num_experts_per_tok=8,
                      num_shared_experts=0, shared_d_ff=0,
                      capacity_factor=1.25),
        skip_shapes=_SKIP,
        source="hf:Qwen/Qwen3-235B-A22B; 94L d=4096 64H GQA(kv=4) 128e top-8",
    )
