"""Architecture registry: one module per assigned architecture.

Importing this package registers all configs; use
``repro_torch.configs.get_config("mixtral-8x22b")`` (or
``"<name>-smoke"``). Host-only dataclasses, the same configurations as
the JAX package's ``configs``.
"""

from .base import (SHAPES, ModelConfig, ShapeSpec, get_config, list_configs,
                   register, shape_applicable)

# Import for registration side effects (one module per assigned arch);
# kept as one visually grouped block rather than isort-merged.
# isort: off
from . import granite_34b        # noqa: F401
from . import qwen2_72b          # noqa: F401
from . import granite_8b         # noqa: F401
from . import starcoder2_3b      # noqa: F401
from . import hymba_1_5b        # noqa: F401
from . import deepseek_moe_16b   # noqa: F401
from . import mixtral_8x22b      # noqa: F401
from . import rwkv6_7b           # noqa: F401
from . import whisper_small      # noqa: F401
from . import llama32_vision_11b  # noqa: F401
# isort: on

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "get_config",
           "list_configs", "register", "shape_applicable"]
