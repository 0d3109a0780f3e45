"""The port's dry-run counts beside the JAX package's, on smoke cells.

  PYTHONPATH=src python tests/torch_dryrun_parity.py

prints, for every smoke config and step kind at (S 64, B 2) on a
one-position mesh, the dot FLOPs that ``repro.roofline.hlo_cost`` reads
off XLA's compiled module, the FLOPs the port counts on ``meta``
(``StepBundle.lower()``), the difference that ``port_minus_jax`` explains
op by op, and both packages' argument bytes; then the (2, 2, 2) smoke
cells' HLO wire bytes beside the port's derived collectives. The tests
(``tests/test_torch_roofline.py``, ``tests/test_torch_dryrun.py``) import
the same functions.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

B, S = 2, 64
KINDS = ("train", "prefill", "decode")


@functools.lru_cache(maxsize=None)
def jax_counts(arch: str, kind: str, b: int = B, s: int = S):
    """(HLO dot FLOPs, argument bytes) of ``repro``'s step on a
    one-device mesh."""
    from repro.configs import ShapeSpec, get_config
    from repro.launch import steps as JS
    from repro.launch.mesh import make_mesh
    from repro.roofline.hlo_cost import analyze_hlo_text

    cfg = get_config(arch).smoke()
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh:
        compiled = JS.build_step(cfg, mesh, ShapeSpec("t", s, b, kind)) \
            .lower().compile()
    return (int(analyze_hlo_text(compiled.as_text()).flops),
            int(compiled.memory_analysis().argument_size_in_bytes))


def port_lowered(arch: str, kind: str, b: int = B, s: int = S,
                 mesh=None, **cfg_changes):
    """``StepBundle.lower()`` of the port's step for the same cell."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_config(arch).smoke(), **cfg_changes)
    mesh = mesh or make_mesh((1, 1), ("data", "model"), device="meta")
    return TS.build_step(cfg, mesh, ShapeSpec("t", s, b, kind)).lower()


def port_minus_jax(arch: str, kind: str, b: int = B, s: int = S) -> int:
    """The FLOPs the port counts beyond XLA's dots, op by op.

    * train, rwkv6 / hymba: a time step's outer product k⊗v (rwkv6) or
      x⊗(B·dt) (hymba) is a multiply in both packages, and its backward
      differs. XLA contracts two dots for the factors' gradients, where
      torch multiplies and sums; torch runs the gradient of ``y = r·M``
      with respect to M as a K = 1 ``bmm``, where XLA multiplies. Net:
      one outer product less a step and a layer, -2·B·H·P·Q·S·L for a
      (P, Q) state.
    * prefill: ``_build_cache`` projects q, k and v again for the decode
      cache, and over the memory for a cross-attention cache. XLA merges
      the k and v with the forward's (CSE) and drops the unused q; the
      port computes all three: 2·B·S·d·(H + 2·KV)·hd a layer with self
      attention, 2·B·S_mem·d·(H + 2·KV)·hd a layer with cross attention.
    * decode: a cross-attention layer projects the new token's k and v,
      which its static cache never reads; XLA drops them, the port
      computes them: 2·2·B·d·KV·hd a layer with cross attention.
    """
    from repro_torch.configs import get_config
    from repro_torch.models.model import layer_plan

    cfg = get_config(arch).smoke()
    hd, d = cfg.resolved_head_dim, cfg.d_model
    plan = layer_plan(cfg)
    if kind == "train":
        if cfg.family == "ssm":
            return -2 * b * cfg.n_heads * hd * hd * s * cfg.n_layers
        if cfg.family == "hybrid":
            return (-2 * b * (cfg.ssm_heads or cfg.n_heads) * hd
                    * cfg.ssm_state * s * cfg.n_layers)
        return 0
    qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    cross = sum(g.count for g in plan if g.kind in ("dec", "cross"))
    if kind == "prefill":
        mem = cfg.encoder_seq or cfg.vision_seq
        selfs = sum(g.count for g in plan if g.kind not in ("rwkv",
                                                            "cross"))
        return 2 * b * d * qkv * (s * selfs + mem * cross)
    return cross * 4 * b * d * cfg.n_kv_heads * hd


def jax_prunes(arch: str, kind: str, b: int = B, s: int = S) -> int:
    """Bytes of the step's arguments that JAX's jit drops as unused
    (``keep_unused=False``), which ``argument_size_in_bytes`` therefore
    leaves out and the port's argument bytes (every leaf) keep. A train
    step reads every leaf (AdamW updates them all). Prefill and decode
    do not read an RWKV6 layer's ``tm/cm_*`` leaves (``rwkv_defs`` declares
    the channel-mix weights in the time-mix dict too), nor a decode step
    a cross attention's ``wk`` / ``wv`` (its cache is static), the
    encoder, or an RWKV6 step's ``pos``."""
    from repro_torch.models.model import param_specs
    from repro_torch.tree_util import tree_flatten_with_path

    from repro_torch.configs import get_config

    if kind == "train":
        return 0
    cfg = get_config(arch).smoke()

    def unused(path):
        if "/tm/cm_" in path:
            return True
        return kind == "decode" and (
            path.endswith(("/xattn/wk", "/xattn/wv"))
            or path.startswith(("encoder/", "embed/enc_")))

    leaves = tree_flatten_with_path(param_specs(cfg)[0])[0]
    total = sum(t.numel() * t.element_size() for p, t in leaves
                if unused(p))
    if kind == "decode" and cfg.family == "ssm":
        total += 4                                  # pos: int32, unread
    return total


WIRE_CELLS = (("granite-8b", "train"), ("mixtral-8x22b", "decode"))

_JAX_WIRE = """
import dataclasses, json
from repro.configs import ShapeSpec, get_config
from repro.launch import steps as S
from repro.launch.mesh import make_mesh
from repro.roofline.hlo_cost import analyze_hlo_text
out = {}
mesh = make_mesh((2, 2, 2), ('pod', 'data', 'model'))
for arch, kind in %r:
    cfg = get_config(arch).smoke()
    with mesh:
        c = S.build_step(cfg, mesh, ShapeSpec('t', 64, 4, kind)).lower() \\
            .compile()
    hc = analyze_hlo_text(c.as_text())
    out[arch + ':' + kind] = [c.memory_analysis().argument_size_in_bytes,
                              hc.wire_bytes, dict(hc.wire_by_kind)]
print('WIRE', json.dumps(out))
"""


def jax_mesh_cells(run_py):
    """{cell: [argument bytes a device, HLO wire bytes a device, wire by
    kind]} of ``WIRE_CELLS`` at (S 64, B 4) on (2, 2, 2), from an
    8-device subprocess (``run_py`` is ``tests/helpers.py``'s)."""
    import json
    out = run_py(_JAX_WIRE % (WIRE_CELLS,), devices=8, timeout=600)
    line = [x for x in out.splitlines() if x.startswith("WIRE ")][0]
    return json.loads(line[5:])


def port_mesh_cell(arch: str, kind: str):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    return port_lowered(arch, kind, b=4, s=64, mesh=mesh)


def main():
    from repro_torch.configs import list_configs

    from helpers import run_py

    print("| arch | kind | JAX HLO dot FLOPs | port on meta | port - JAX "
          "| explained | JAX arg bytes | port arg bytes | JAX drops |")
    print("|---|---|---|---|---|---|---|---|---|")
    for arch in list_configs():
        for kind in KINDS:
            jf, ja = jax_counts(arch, kind)
            low = port_lowered(arch, kind)
            print(f"| {arch} | {kind} | {jf:,} | {low.flops:,} "
                  f"| {low.flops - jf:,} | {port_minus_jax(arch, kind):,} "
                  f"| {ja:,} | {low.argument_bytes:,.0f} "
                  f"| {jax_prunes(arch, kind):,} |")
    jax = jax_mesh_cells(run_py)
    print("\n(2, 2, 2) smoke cells, S 64 x B 4, a position:")
    for arch, kind in WIRE_CELLS:
        arg, wire, by_kind = jax[f"{arch}:{kind}"]
        low = port_mesh_cell(arch, kind)
        port = low.collective_breakdown()
        print(f"{arch} {kind}: JAX HLO wire {wire:,.0f} B "
              f"{ {k: v for k, v in by_kind.items() if v} }; port derived "
              f"{port['bytes.total']:,.0f} B "
              f"{ {k: v for k, v in port.items() if v and 'bytes.' in k} }; "
              f"argument bytes JAX {arg:,} port {low.argument_bytes:,.0f}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
