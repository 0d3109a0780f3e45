"""PICSOU / C3B reproduction on PyTorch and CUDA.

The port of the JAX package ``repro`` to PyTorch, with the TPU kernels
rewritten by hand for NVIDIA Hopper. It mirrors ``repro``'s layout and
names (``repro_torch.core``, ``repro_torch.kernels``, ``repro_torch.obs``,
``repro_torch.topology``, ``repro_torch.apps``, ``repro_torch.replay``,
``repro_torch.adversary``, ``repro_torch.stream``,
``repro_torch.analysis``, and the cross-pod runtime:
``repro_torch.consensus``, ``repro_torch.crosspod``,
``repro_torch.launch`` (the mesh held on one card, elastic replanning),
``repro_torch.optim``, ``repro_torch.data``, ``repro_torch.checkpoint``,
``repro_torch.configs``, on trees of tensors from
``repro_torch.tree_util``; the serving path of the model zoo,
``repro_torch.models`` with ``repro_torch.launch.serve``) and imports
nothing of ``repro`` or JAX.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from . import core, kernels

__all__ = ["core", "kernels"]
