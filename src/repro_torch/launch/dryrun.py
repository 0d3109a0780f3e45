"""Dry run on ``meta`` tensors: count every (arch x shape x mesh) cell.

The JAX package lowers and compiles each cell against
``ShapeDtypeStruct``s on 512 forced host devices. The port has nothing
to compile and no device to force: every cell's step runs on ``meta``
tensors on the production mesh (``make_production_mesh(device="meta")``),
so this is the one entry point that uses no device. It allocates and
computes nothing, and runs on any machine. For every cell it

  1. builds the step (train_step / prefill / serve_step),
  2. records its shardings from the logical rules,
  3. counts it with ``StepBundle.lower()`` (``roofline.lowered``): FLOPs
     and bytes, the arguments' bytes on one position, the collectives
     derived from the shardings,
  4. prices the three roofline terms on the H100 (``roofline.HW_H100``),
  5. appends one JSON record to the results file.

A record keeps the JAX package's keys, except ``compile_s`` (nothing is
compiled; ``compile_s_absent`` says so), and adds ``impl``, ``backend``
("torch-meta"), ``hw`` and the bases of its figures. The default results
file is not the JAX package's, and a resume reads only this backend's
records.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
      --arch all --out dryrun_torch_results.jsonl
  PYTHONPATH=src python -m repro_torch.roofline.report \\
      dryrun_torch_results.jsonl
"""

import argparse
import json
import os
import time
import traceback

BACKEND = "torch-meta"
DEFAULT_OUT = "dryrun_torch_results.jsonl"


def apply_opts(cfg, opts: str):
    """Apply §Perf levers: 'moe2d', 'rwkvblock=16', 'noremat',
    'rematdots', 'moedense'."""
    import dataclasses
    for opt in filter(None, (opts or "").split(",")):
        if opt == "moe2d":
            cfg = dataclasses.replace(cfg, moe_dispatch_2d=True)
        elif opt.startswith("rwkvblock="):
            cfg = dataclasses.replace(cfg,
                                      rwkv_scan_block=int(opt.split("=")[1]))
        elif opt == "noremat":
            cfg = dataclasses.replace(cfg, remat=False)
        elif opt == "rematdots":
            cfg = dataclasses.replace(cfg, remat_policy="dots")
        elif opt == "moedense":
            cfg = dataclasses.replace(cfg, moe_impl="dense")
        else:
            raise ValueError(f"unknown opt {opt!r}")
    return cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             impl=None, out_path=None, verbose=True, extra_tag="",
             opts: str = ""):
    """Count one cell and return (and append to ``out_path``) its
    record."""
    from ..configs import SHAPES, get_config, shape_applicable
    from ..roofline import HW_H100, analyze_lowered
    from ..roofline.collectives import BASIS
    from ..roofline.lowered import (BYTES_BASIS, FLOPS_BASIS,
                                    POSITION_BASIS)
    from . import steps as S
    from .mesh import make_production_mesh

    cfg = apply_opts(get_config(arch), opts)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "impl": impl or "scan", "tag": extra_tag, "backend": BACKEND}
    if not ok:
        rec.update(status="SKIP", reason=why)
        _emit(rec, out_path, verbose)
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device="meta")
    n_chips = mesh.size
    t0 = time.time()
    try:
        bundle = S.build_step(cfg, mesh, shape, impl=impl)
        lowered = bundle.lower()
        t1 = time.time()
        rep = analyze_lowered(lowered, cfg, shape, mesh_kind, n_chips,
                              hw=HW_H100)
        rec.update(
            status="OK", lower_s=round(t1 - t0, 1),
            compile_s_absent="eager torch: a meta count compiles nothing",
            hlo_flops_per_chip=rep.hlo_flops_per_chip,
            hlo_bytes_per_chip=rep.hlo_bytes_per_chip,
            wire_bytes_per_chip=rep.wire_bytes_per_chip,
            model_flops_total=rep.model_flops_total,
            compute_s=rep.compute_s, memory_s=rep.memory_s,
            collective_s=rep.collective_s, bottleneck=rep.bottleneck,
            useful_ratio=rep.useful_ratio,
            collectives={k: v for k, v in rep.collective_breakdown.items()
                         if v},
            memory_analysis=rep.memory_analysis[:2000],
            argument_bytes_per_chip=lowered.argument_bytes,
            hw=HW_H100.name, flops_basis=FLOPS_BASIS,
            bytes_basis=BYTES_BASIS, per_chip_basis=POSITION_BASIS,
            collective_basis=BASIS,
        )
        if verbose:
            print(f"--- {arch} x {shape_name} x {mesh_kind} "
                  f"({rec['impl']}) ---")
            print("memory_analysis:", rep.memory_analysis[:400])
            print(f"cost: flops/chip={rep.hlo_flops_per_chip:.3e} "
                  f"bytes/chip={rep.hlo_bytes_per_chip:.3e} "
                  f"wire/chip={rep.wire_bytes_per_chip:.3e}")
            print(f"roofline ({HW_H100.name}): compute={rep.compute_s:.4f}s "
                  f"memory={rep.memory_s:.4f}s "
                  f"collective={rep.collective_s:.4f}s "
                  f"-> {rep.bottleneck}-bound "
                  f"(useful={rep.useful_ratio:.2f})")
    except Exception as e:  # noqa: BLE001
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"--- {arch} x {shape_name} x {mesh_kind} FAILED: {e}")
    _emit(rec, out_path, verbose=False)
    return rec


def _emit(rec, out_path, verbose):
    if verbose:
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("memory_analysis", "trace")}))
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def cached(path: str):
    """Keys of the OK / SKIP records of this backend in ``path``."""
    done = set()
    if not path or not os.path.exists(path):
        return done
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("backend") == BACKEND and r.get("status") in ("OK",
                                                                   "SKIP"):
                done.add((r["arch"], r["shape"], r["mesh"],
                          r.get("impl", "scan"), r.get("tag", "")))
    return done


def main(argv=None):
    from ..configs import SHAPES, list_configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--impl", default=None,
                    choices=[None, "scan", "triangular"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", default="",
                    help="comma list: moe2d, rwkvblock=N, noremat")
    args = ap.parse_args(argv)

    archs = list_configs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    done = cached(args.out)
    n_fail = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                key = (arch, shape, mesh_kind, args.impl or "scan", args.tag)
                if key in done:
                    print(f"skip (cached): {key}")
                    continue
                rec = run_cell(arch, shape, mesh_kind, impl=args.impl,
                               out_path=args.out, extra_tag=args.tag,
                               opts=args.opt)
                n_fail += rec["status"] == "FAIL"
    print(f"dry-run complete; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
