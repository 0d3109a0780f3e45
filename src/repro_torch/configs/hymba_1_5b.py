"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads
[arXiv:2411.13676; hf]. Most layers use sliding-window attention; every
8th layer is global (the hymba paper keeps 3 global layers). The mamba
heads run in parallel with the attention heads inside every block.
"""
from .base import ModelConfig, register


@register("hymba-1.5b")
def hymba_1_5b() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001, head_dim=64,
        ssm_state=16, ssm_heads=25,
        sliding_window=1024, global_layer_period=11,
        source="[arXiv:2411.13676; hf]",
    )
