"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16, MHA) d_ff=1408
vocab=102400, MoE 64 routed experts top-6 + 2 shared, fine-grained;
layer 0 keeps a dense FFN [arXiv:2401.06066; hf]."""
from .base import ModelConfig, register


@register("deepseek-moe-16b")
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944,  # dense-FFN width for the first dense layer
        vocab=102400, head_dim=128,
        n_experts=64, n_shared_experts=2, top_k=6, expert_d_ff=1408,
        first_dense_layers=1,
        source="[arXiv:2401.06066; hf]",
    )
