"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — gated cross-attn image layers every 5 layers; vision tower
is a STUB (input_specs() provides precomputed patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from .base import ModelConfig, register


@register("llama-3.2-vision-11b")
def llama32_vision_11b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, head_dim=128,
        cross_attn_period=5, vision_seq=1601,
        rope_theta=5e5,
        source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
    )
