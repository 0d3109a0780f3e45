"""repro_torch.analysis — static and runtime correctness tooling for the
engine.

PICSOU's performance claim rests on contracts the type system cannot
see: one dispatch per K fused chunks, zero implicit device->host
transfers inside the windowed loop, zero recompilation (capture) on warm
replay resume. On the card every chunk, superchunk and dense block is a
captured CUDA graph, where a host read fails the capture; on the CPU the
same bodies run eagerly and such a read passes silently. Three passes,
the counterparts of the JAX package's, enforce the contracts:

``astlint``
    A capture-discipline AST linter over ``src/repro_torch/**``: no host
    read (``.item()`` / ``.cpu()`` / ``float()`` / ``np.asarray()`` of a
    tensor, ``nonzero`` ...) and no Python ``if`` / ``while`` on a tensor
    inside a captured body or anything it reaches (across the package's
    imports), no tensor factory or ``torch.cuda`` call at import time,
    and no Python scalar in captured state or tensor in a program key.
    Findings carry rule IDs, fix-it hints, the ``# analysis:
    ignore[rule]`` suppression and the port's baseline file
    (``baseline.txt`` beside this package, the JAX package's format).

``programlint``
    A captured-program auditor that builds the engine's dense, chunk,
    superchunk, metrics and horizon-mode programs with the loop's own
    constructors and runs each once on clones of its state under an op
    recorder: host syncs, dtype widenings, CPU operands and (on the
    card) ``quack_scan`` launch counts, with argument and copy-back
    bytes and dispatch estimates, as the machine-readable
    ``ANALYSIS.json`` report.

``sanitizer``
    A context manager that counts the engine's dispatches, host syncs
    and captures and catches a tensor reaching the host outside the
    sanctioned routes (the card's sync debug mode plus an interposition
    on the tensor-to-host conversions), so tests and benches assert
    their dispatch contract ("<= ceil(C/K)+2 dispatches, 0 implicit
    transfers, 0 recompiles warm") declaratively. The windowed engine
    arms it automatically behind ``SimConfig.debug_checks``.

``python -m repro_torch.analysis --check`` runs all three passes (the
engine's on the card, or with ``--device cpu`` on the CPU) and is the
port's lint gate.
"""

from .astlint import (JAX_RULES, RULES, Finding, lint_paths, lint_source,
                      lint_tree, load_baseline, partition)
from .programlint import (ProgramAudit, audit_callable, audit_engine,
                          estimate_dispatches)
from .sanitizer import (DispatchContract, SanitizerError, SanitizerReport,
                        dispatch_bound, dispatch_contract, engine_guard,
                        sanitized)

__all__ = [
    "Finding", "RULES", "JAX_RULES", "lint_source", "lint_paths",
    "lint_tree", "load_baseline", "partition",
    "ProgramAudit", "audit_callable", "audit_engine", "estimate_dispatches",
    "DispatchContract", "SanitizerError", "SanitizerReport",
    "dispatch_bound", "dispatch_contract", "sanitized", "engine_guard",
]
