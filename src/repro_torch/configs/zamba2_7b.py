"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig, register


@register("zamba2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14_336,  # shared transformer block FFN
        vocab_size=32_000,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=10_000.0,
        ssm=SSMConfig(state_size=64, head_dim=64, expand=2, conv_kernel=4,
                      ngroups=1, chunk_size=256),
        hybrid=HybridConfig(attn_every=6),
        source="arXiv:2411.15242; 81L d=3584 hybrid mamba2+shared attn, "
               "ssm_state=64",
    )
