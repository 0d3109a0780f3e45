"""Roofline analysis of the port: a step counted on ``meta`` tensors
(``count``, ``lowered``), collectives derived from its shardings
(``collectives``), the three-term model (``model``), the dry run's table
(``report``) and the collectives inspector (``inspect``).

The JAX package's ``roofline/hlo.py`` and ``hlo_cost.py`` parse XLA's
HLO text; torch emits none, so ``count`` and ``collectives`` take their
place.
"""

from .model import (HW, HW_H100, RooflineReport, analyze_lowered,
                    model_flops, roofline_terms)

__all__ = ["HW", "HW_H100", "RooflineReport", "analyze_lowered",
           "roofline_terms", "model_flops"]
