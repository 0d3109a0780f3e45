"""Model zoo: dense GQA / MoE / RWKV6 / hybrid / enc-dec / VLM, on trees
of tensors: random init, the training loss, prefill and decode, and the
shape declarations and sharding rules of a step.

Attention takes the hand-written kernel on CUDA
(``models.attention.attention``; its backward is the gradient of the
plain scan); weights carry over from the JAX package with
``params_from_numpy``.
"""

from .model import (cache_specs, decode_step, encode, forward, init_model,
                    input_specs, layer_plan, loss_fn, model_defs,
                    param_specs, prefill)
from .params import count_params, params_from_numpy
from .sharding import DEFAULT_RULES, sharding_for, spec_for, tree_shardings

__all__ = ["forward", "loss_fn", "prefill", "decode_step", "encode",
           "init_model", "model_defs", "param_specs", "layer_plan",
           "input_specs", "cache_specs", "count_params",
           "params_from_numpy", "DEFAULT_RULES", "spec_for", "sharding_for",
           "tree_shardings"]
