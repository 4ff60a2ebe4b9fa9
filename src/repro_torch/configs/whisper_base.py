"""whisper-base — enc-dec, conv frontend (stub) [arXiv:2212.04356].

Per the assignment the conv frontend is a STUB: the caller passes
precomputed frame embeddings of shape (batch, 1500, d_model) to the
bidirectional encoder (the serving engine passes zeros); the decoder is
autoregressive with self + cross attention.
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig, register

_SKIP = (("long_500k",
          "full-attention enc-dec: 500k decode requires sub-quadratic "
          "attention (and whisper has no 500k context); skipped per "
          "assignment"),)


@register("whisper-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        num_layers=6,  # decoder layers
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=51_865,
        norm="layernorm",
        activation="gelu",
        rope_theta=0.0,  # whisper uses learned/sinusoidal absolute positions
        encdec=EncDecConfig(num_encoder_layers=6, encoder_seq_len=1500),
        skip_shapes=_SKIP,
        source="arXiv:2212.04356; whisper-base 6L enc + 6L dec d=512 8H",
    )
