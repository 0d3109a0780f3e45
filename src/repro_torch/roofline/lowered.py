"""``StepBundle.lower()``'s result: a step counted on ``meta`` tensors.

The JAX package lowers and compiles a step against ``ShapeDtypeStruct``s
and reads ``cost_analysis()`` and ``memory_analysis()`` off the compiled
module. Torch has no lowering: ``lower`` runs the bundle's step on its
``meta`` ``in_shapes`` under a scaling ``count.Counter`` (nothing is
allocated, nothing computed) and keeps the counts, the arguments' bytes
on one position and the collectives derived from the shardings.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

from . import collectives as C
from .count import Counter

__all__ = ["Lowered", "MemoryAnalysis", "lower", "FLOPS_BASIS",
           "BYTES_BASIS", "POSITION_BASIS"]

FLOPS_BASIS = ("torch.utils.flop_counter's formulas over the aten ops "
               "the step dispatches on meta tensors (matrix products, "
               "2*M*N*K), uniform loops counted as trip count x one "
               "iteration")
BYTES_BASIS = ("unfused eager: every aten op's tensor inputs and outputs, "
               "views and ops returning no tensor skipped, uniform loops "
               "counted as trip count x one iteration")
POSITION_BASIS = ("the whole step's count divided evenly over the mesh's "
                  "positions (the port computes whole tensors on one card)")


@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """The part of ``compiled.memory_analysis()`` the port can state."""

    argument_size_in_bytes: float

    def __str__(self) -> str:
        return (f"MemoryAnalysis(argument_size_in_bytes="
                f"{self.argument_size_in_bytes:.0f} a position, from the "
                f"recorded shardings; temporaries not modelled)")


@dataclasses.dataclass
class Lowered:
    flops: int
    bytes: int
    positions: int
    argument_bytes: float
    collectives: List[C.DerivedCollective]
    host_s: float

    def cost_analysis(self) -> Dict[str, float]:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes),
                "flops_per_position": self.flops / self.positions,
                "bytes_per_position": self.bytes / self.positions}

    def memory_analysis(self) -> MemoryAnalysis:
        return MemoryAnalysis(self.argument_bytes)

    def collective_breakdown(self) -> Dict[str, float]:
        return C.breakdown(self.collectives)


def lower(bundle) -> Lowered:
    """Count ``bundle``'s step on its ``meta`` inputs (a decode step's
    position is its meta int32 scalar, as the JAX step traces it)."""
    args = tuple(bundle.in_shapes)
    t0 = time.perf_counter()
    with Counter(scale_loops=True) as c:
        bundle.fn(*args)
    host_s = time.perf_counter() - t0
    mesh = bundle.mesh
    train = bundle.shape is not None and bundle.shape.kind == "train"
    colls = C.derive_collectives(bundle.in_shapes[0], bundle.in_shardings[0],
                                 mesh, bundle.rules, train)
    return Lowered(flops=c.flops, bytes=c.bytes, positions=mesh.size,
                   argument_bytes=C.argument_bytes(
                       bundle.in_shapes, bundle.in_shardings, mesh),
                   collectives=colls, host_s=host_s)
