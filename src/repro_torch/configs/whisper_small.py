"""whisper-small [audio]: 12L d_model=768 12H d_ff=3072 vocab=51865 —
enc-dec; conv frontend is a STUB (input_specs() provides precomputed
1500-frame embeddings) [arXiv:2212.04356; unverified]."""
from .base import ModelConfig, register


@register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865, head_dim=64,
        encoder_layers=12, encoder_seq=1500,
        source="[arXiv:2212.04356; unverified]",
    )
