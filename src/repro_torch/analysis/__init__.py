"""repro_torch.analysis — the engine's runtime contracts.

PICSOU's performance claim rests on contracts the type system cannot
see: one dispatch per K fused chunks, zero implicit device->host
transfers inside the windowed loop, zero recompilation (capture) on warm
replay resume. :mod:`~repro_torch.analysis.sanitizer` enforces them at
run time: a context manager that counts the engine's dispatches, host
syncs and captures and catches a tensor reaching the host outside the
sanctioned routes (the card's sync debug mode plus an interposition on
the tensor-to-host conversions), so tests and benches assert their
dispatch contract ("<= ceil(C/K)+2 dispatches, 0 implicit transfers, 0
recompiles warm") declaratively. The windowed engine arms it
automatically behind ``SimConfig.debug_checks``.

``python -m repro_torch.analysis --check`` runs the sanitizer's cold and
warm engine runs. The JAX package's other two passes, the AST linter of
trace discipline (``astlint``) and the jaxpr / HLO auditor
(``jaxprlint``), walk JAX source and staged JAX programs; this package
has neither, so they are not ported.
"""

from .sanitizer import (DispatchContract, SanitizerError, SanitizerReport,
                        dispatch_bound, dispatch_contract, engine_guard,
                        sanitized)

__all__ = [
    "DispatchContract", "SanitizerError", "SanitizerReport",
    "dispatch_bound", "dispatch_contract", "sanitized", "engine_guard",
]
