"""internvl2-26b — InternViT + InternLM2 [arXiv:2404.16821].

Per the assignment, only the transformer BACKBONE (InternLM2-20B decoder) is
modeled; the InternViT frontend is a STUB — the caller passes precomputed
patch embeddings (``ServingEngine.submit(patch_embeds=)``, zeros when
absent), which are projected and prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig, register

_SKIP = (("long_500k",
          "full-attention VLM backbone: 500k decode requires sub-quadratic "
          "attention; skipped per assignment"),)


@register("internvl2-26b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16_384,
        vocab_size=92_553,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=1_000_000.0,
        num_patches=256,  # stub InternViT: 256 patch embeddings per image
        skip_shapes=_SKIP,
        source="arXiv:2404.16821; LM backbone 48L d=6144 48H GQA(kv=8)",
    )
