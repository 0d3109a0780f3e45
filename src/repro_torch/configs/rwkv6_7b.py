"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892; hf]."""
from .base import ModelConfig, register


@register("rwkv6-7b")
def rwkv6_7b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab=65536, head_dim=64,
        ssm_state=64,
        source="[arXiv:2404.05892; hf]",
    )
