"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("mamba2-1.3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        head_dim=1,  # unused (attention-free)
        d_ff=0,  # attention-free, no separate FFN: mamba2 block only
        vocab_size=50_280,
        norm="rmsnorm",
        tie_embeddings=True,
        ssm=SSMConfig(state_size=128, head_dim=64, expand=2, conv_kernel=4,
                      ngroups=1, chunk_size=256),
        source="arXiv:2405.21060 (mamba2-1.3b); attn-free, ssm_state=128",
    )
