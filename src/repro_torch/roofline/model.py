"""Three-term roofline of a step, from its count on ``meta`` tensors.

  compute term    = FLOPs_per_position / peak_FLOP/s
  memory term     = bytes_per_position / HBM_bw
  collective term = wire_bytes_per_position / link_bw

The JAX package reads the three figures off XLA's compiled module
(``repro.roofline.model.analyze_compiled``). The port has no compiled
module: ``launch.steps.StepBundle.lower`` counts the step's aten ops
(``roofline.count``) and derives the wire bytes from the recorded
shardings (``roofline.collectives``). ``model_flops`` is the analytic
6·N·D (dense) / 6·N_active·D (MoE) + attention term; MODEL/counted
surfaces remat recompute and masked-block waste.

``HW()`` keeps the JAX package's TPU v5e constants, so that the two
packages' terms can be compared; ``HW_H100`` is the card the port runs
on, for its own reports.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..configs.base import ModelConfig, ShapeSpec

__all__ = ["HW", "HW_H100", "RooflineReport", "analyze_lowered",
           "roofline_terms", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    """Per-chip constants; the defaults are the JAX package's TPU v5e."""

    peak_flops: float = 197e12        # bf16 FLOP/s
    hbm_bw: float = 819e9             # B/s
    link_bw: float = 50e9             # B/s per ICI link
    hbm_bytes: float = 16e9
    name: str = "TPU v5e"


# NVIDIA H100 SXM5 80GB at 700 W, from its datasheet
HW_H100 = HW(
    peak_flops=989e12,   # bf16 tensor-core FLOP/s, dense
    hbm_bw=3.35e12,      # HBM3, B/s
    link_bw=450e9,       # NVLink 4, B/s in each direction
    hbm_bytes=80e9,      # HBM3 capacity
    name="H100 SXM5 80GB",
)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    wire_bytes_per_chip: float
    model_flops_total: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float              # MODEL_FLOPS / (FLOPs * positions)
    collective_breakdown: Dict[str, float]
    memory_analysis: str = ""

    def as_row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.n_chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "hlo_gflops_per_chip": self.hlo_flops_per_chip / 1e9,
            "hbm_GB_per_chip": self.hlo_bytes_per_chip / 1e9,
            "wire_MB_per_chip": self.wire_bytes_per_chip / 1e6,
        }


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic useful FLOPs for one step of this cell.

    Train: 6*N*D (fwd+bwd) + attention 12*L*S^2*d_attn*B (causal halved).
    Prefill: 2*N*D + attention. Decode: 2*N_active*B + cache reads ~0 FLOPs
    (memory-bound; FLOPs = 2*N_active per token + attention S*d per layer).
    """
    n_active = cfg.n_active_params()
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    d_attn = cfg.n_heads * hd
    if shape.kind == "train":
        tokens = b * s
        core = 6.0 * n_active * tokens
        attn = 0.0
        if cfg.family != "ssm":
            w = cfg.sliding_window or s
            ctx = min(w, s)
            attn = 12.0 * cfg.n_layers * b * s * ctx * d_attn * 0.5
        return core + attn
    if shape.kind == "prefill":
        tokens = b * s
        core = 2.0 * n_active * tokens
        attn = 0.0
        if cfg.family != "ssm":
            w = cfg.sliding_window or s
            ctx = min(w, s)
            attn = 4.0 * cfg.n_layers * b * s * ctx * d_attn * 0.5
        return core + attn
    # decode: one token per sequence
    core = 2.0 * n_active * b
    attn = 0.0
    if cfg.family != "ssm":
        w = cfg.sliding_window or s
        ctx = min(w, s)
        attn = 4.0 * cfg.n_layers * b * ctx * d_attn
    return core + attn


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   wire_per_chip: float, hw: HW = HW()) -> Dict[str, float]:
    return {
        "compute_s": flops_per_chip / hw.peak_flops,
        "memory_s": bytes_per_chip / hw.hbm_bw,
        "collective_s": wire_per_chip / hw.link_bw,
    }


def analyze_lowered(lowered, cfg: ModelConfig, shape: ShapeSpec,
                    mesh_name: str, n_chips: int,
                    hw: HW = HW()) -> RooflineReport:
    """The report of a step counted by ``StepBundle.lower()``, with the
    fields of the JAX package's ``analyze_compiled``: per-position FLOPs
    and bytes from the count, wire bytes from the derived collectives."""
    cost = lowered.cost_analysis()
    flops = cost["flops_per_position"]
    byts = cost["bytes_per_position"]
    coll = lowered.collective_breakdown()
    wire = coll["bytes.total"]
    coll["raw.count.flops"] = float(cost["flops"])
    coll["raw.count.bytes"] = float(cost["bytes accessed"])
    terms = roofline_terms(flops, byts, wire, hw)
    bottleneck = max(terms, key=terms.get).replace("_s", "")
    mf = model_flops(cfg, shape)
    useful = mf / max(flops * n_chips, 1.0)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        hlo_flops_per_chip=flops, hlo_bytes_per_chip=byts,
        wire_bytes_per_chip=wire, model_flops_total=mf,
        compute_s=terms["compute_s"], memory_s=terms["memory_s"],
        collective_s=terms["collective_s"], bottleneck=bottleneck,
        useful_ratio=useful, collective_breakdown=coll,
        memory_analysis=str(lowered.memory_analysis()))
