"""Hand-written GPU kernels for the perf-critical layers.

``quack_scan``: the QUACK quorum aggregation of every protocol round, in
CUDA C++ (``csrc/quack_scan.cu``), with its plain torch version
``ref.quack_reference``. Each op in ``ops`` runs the kernel on CUDA
tensors and the plain version on CPU tensors.
"""

from . import ref
from .ops import quack_scan

__all__ = ["quack_scan", "ref"]
