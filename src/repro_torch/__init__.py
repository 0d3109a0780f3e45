"""PICSOU / C3B reproduction on PyTorch and CUDA.

The port of the JAX package ``repro`` to PyTorch, with the TPU kernels
rewritten by hand for NVIDIA Hopper. It mirrors ``repro``'s layout and
names (``repro_torch.core``, ``repro_torch.kernels``, ``repro_torch.obs``,
``repro_torch.topology``, ``repro_torch.apps``, ``repro_torch.replay``,
``repro_torch.adversary``) and imports nothing of ``repro`` or JAX.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from . import core, kernels

__all__ = ["core", "kernels"]
