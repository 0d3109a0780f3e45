"""Hand-written GPU kernels for the perf-critical layers.

Each op in ``ops`` runs its CUDA C++ kernel on CUDA tensors and its plain
torch version (``ref``) on CPU tensors:

- ``quack_scan``: the QUACK quorum aggregation of every protocol round
  (``csrc/quack_scan.cu``, plain ``ref.quack_reference``);
- ``flash_attention``: causal / sliding-window / grouped-query attention
  on wgmma and TMA, bf16 on ``csrc/flash_attention_sm90.cu`` (P in two
  bf16 halves), f32 on ``csrc/flash_attention_f32_sm90.cu`` (three TF32
  passes; plain ``ref.mha_reference``, and ``ref.mha_split_p`` and
  ``ref.mha_split_tf32`` the kernels' arithmetic);
- ``rwkv6_chunked``: the RWKV6 recurrence (``csrc/rwkv6_scan.cu``: the
  state register-blocked, the u bonus factored out, stages filled by bulk
  copies; plain ``ref.rwkv6_reference``, and ``ref.rwkv6_factored`` the
  kernel's arithmetic).
"""

from . import ref
from .ops import flash_attention, quack_scan, rwkv6_chunked

__all__ = ["quack_scan", "flash_attention", "rwkv6_chunked", "ref"]
