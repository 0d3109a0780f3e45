"""Per-leaf collective inspector: the top-N derived collectives of a cell.

The JAX package compiles a cell and ranks the collectives XLA inserted,
by execution-count-weighted wire bytes. The port's step runs no
collective (its mesh is held on one card), so this ranks the ones derived
from the recorded shardings (``roofline.collectives.BASIS``, printed in
the header), by parameter leaf:

  PYTHONPATH=src python -m repro_torch.roofline.inspect \
      --arch mixtral-8x22b --shape train_4k --top 12
"""

import argparse


def top_collectives(arch: str, shape: str = "train_4k",
                    mesh: str = "single", impl=None, opt: str = "",
                    top: int = 12):
    """(header lines, rows) of the ``top`` derived collectives of a cell,
    rows ``(wire bytes a position, kind, group, leaf, axes)``."""
    from ..configs import SHAPES, get_config
    from ..launch import steps as S
    from ..launch.dryrun import apply_opts
    from ..launch.mesh import make_production_mesh
    from .collectives import BASIS, derive_collectives

    cfg = apply_opts(get_config(arch), opt)
    sh = SHAPES[shape]
    mesh_obj = make_production_mesh(multi_pod=(mesh == "multi"),
                                    device="meta")
    bundle = S.build_step(cfg, mesh_obj, sh, impl=impl)
    colls = derive_collectives(bundle.in_shapes[0], bundle.in_shardings[0],
                               mesh_obj, bundle.rules, sh.kind == "train")
    rows = sorted(((c.wire_bytes_per_chip, c.kind, c.group_size, c.leaf,
                    c.axes) for c in colls), key=lambda r: -r[0])
    header = [f"# top collectives: {arch} x {shape} x {mesh} "
              f"impl={impl or 'scan'} opt={opt or '-'}",
              f"# basis: {BASIS}",
              "wire_per_chip,kind,group,leaf,axes"]
    return header, rows[:top]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--impl", default=None)
    ap.add_argument("--opt", default="")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    header, rows = top_collectives(args.arch, args.shape, args.mesh,
                                   args.impl, args.opt, args.top)
    print("\n".join(header))
    for w, kind, g, leaf, axes in rows:
        print(f"{w / 1e9:10.4f}GB {kind:16s} g={g:4d} {leaf:48s} "
              f"{'x'.join(axes)}")


if __name__ == "__main__":
    main()
