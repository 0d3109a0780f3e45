"""Model configuration schema + registry for the assigned architectures.

Every architecture in the assignment pool is expressed as a ``ModelConfig``;
``smoke()`` derives a reduced same-family variant for CPU tests. The
port's runtime reads its layer shapes from the FULL configs
(``chip_smoke.py`` syncs a full-width starcoder2-3b layer's gradients).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "register", "get_config",
           "list_configs", "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_dense_layers: int = 0   # deepseek-moe: layer 0 keeps a dense FFN
    capacity_factor: float = 1.25
    # --- attention variants -------------------------------------------
    sliding_window: int = 0       # 0 = full attention
    global_layer_period: int = 0  # hybrid: every k-th layer uses full attn
    # --- SSM / linear-attention ----------------------------------------
    ssm_state: int = 0            # per-head recurrent state width
    ssm_heads: int = 0            # hybrid: parallel SSM heads per layer
    # --- encoder-decoder ------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0          # stub frontend sequence (whisper frames)
    # --- VLM -------------------------------------------------------------
    cross_attn_period: int = 0    # insert a cross-attn layer every k layers
    vision_seq: int = 0           # stub patch-embedding sequence
    # --- numerics --------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # --- runtime ---------------------------------------------------------
    attn_block_q: int = 512       # chunked-attention block sizes (XLA path)
    attn_block_kv: int = 1024
    rwkv_chunk: int = 128
    use_pallas: bool = False      # kept for parity; nothing reads it
    remat: bool = True
    # --- perf levers (EXPERIMENTS.md §Perf; defaults = baseline) ----------
    moe_dispatch_2d: bool = False  # shard the MoE capacity dim over 'data'
    moe_impl: str = "scatter"      # scatter | dense (few-expert MoEs)
    remat_policy: str = "none"     # none | dots (save dot outputs in bwd)
    rwkv_scan_block: int = 1       # timesteps per scan iteration (state
    #                                HBM round-trips / block)
    source: str = ""              # provenance note [arXiv; tier]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / SWA archs)."""
        return (self.family in ("ssm", "hybrid")
                or (self.sliding_window > 0 and self.global_layer_period == 0))

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (enc-dec incl.)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d
        mlp = 3 * d * dff  # SwiGLU
        per_layer = attn + mlp + 2 * d
        if self.family == "moe":
            e_mlp = 3 * self.d_model * self.expert_d_ff
            routed = self.n_experts * e_mlp
            shared = self.n_shared_experts * e_mlp
            router = d * self.n_experts
            per_layer = attn + routed + shared + router + 2 * d
        if self.family == "ssm":
            # rwkv6: time-mix (r,k,v,w,g) + channel-mix
            per_layer = 5 * d * d + 3 * d * dff + 2 * d
        if self.family == "hybrid":
            per_layer = attn + mlp + 2 * d + 3 * d * d  # + ssm head params
        total = self.n_layers * per_layer + 2 * v * d
        if self.encoder_layers:
            total += self.encoder_layers * (d * q * 2 + 2 * d * kv
                                            + 3 * d * dff + 2 * d)
        if self.cross_attn_period:
            n_cross = self.n_layers // self.cross_attn_period
            total += n_cross * (attn + mlp)
        return int(total)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        e_mlp = 3 * d * self.expert_d_ff
        active = attn + (self.top_k + self.n_shared_experts) * e_mlp + 2 * d
        return int(self.n_layers * active + 2 * self.vocab * d)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            expert_d_ff=64 if self.expert_d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            sliding_window=min(self.sliding_window, 16) or 0,
            global_layer_period=self.global_layer_period and 2,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 2) if self.ssm_heads else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            cross_attn_period=self.cross_attn_period and 2,
            vision_seq=min(self.vision_seq, 16) if self.vision_seq else 0,
            attn_block_q=8, attn_block_kv=16, rwkv_chunk=8,
            dtype="float32", param_dtype="float32", remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (skip noted in DESIGN.md)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention arch: 500k decode is quadratic-cost"
    return True, ""


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # allow '<name>-smoke'
        if name.endswith("-smoke") and name[:-6] in _REGISTRY:
            return _REGISTRY[name[:-6]]().smoke()
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    return sorted(_REGISTRY)
