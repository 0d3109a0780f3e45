"""Model zoo: dense GQA / MoE / RWKV6 / hybrid / enc-dec / VLM, the
serving path (random init, prefill, decode) on trees of tensors.

Prefill attention takes the hand-written kernel on CUDA
(``models.attention.attention``); weights carry over from the JAX
package with ``params_from_numpy``.
"""

from .model import (decode_step, encode, forward, init_model, layer_plan,
                    model_defs, prefill)
from .params import count_params, params_from_numpy

__all__ = ["forward", "prefill", "decode_step", "encode", "init_model",
           "model_defs", "layer_plan", "count_params", "params_from_numpy"]
