"""End-to-end training driver, on the card or (``--device cpu``) the CPU.

Two execution modes, as in the JAX package:

* ``pjit``: ``steps.build_train_step``'s step (the production path; its
  shardings are recorded, and on one card it computes on whole
  tensors).
* ``ddp``: data parallel with an EXPLICIT cross-pod gradient sync, so
  that the PICSOU schedule runs end to end: ``--sync picsou`` (RS ->
  pod-AR -> AG, one slow-link copy per shard) or ``--sync ata`` (flat
  all-reduce), over the mesh held on one card (``launch.mesh``).
  ``--compress`` adds int8 error feedback on every gradient leaf when the
  mesh has a 'pod' axis. The gradients synced are those of the global
  batch's mean loss, replicated (``in_specs=P()``), as the JAX package's
  jitted step syncs them.

The two modes use different schedules, as in the JAX package: pjit
``cosine_schedule(step, 100, 10_000)``, ddp ``cosine_schedule(step, 10,
steps * 10)``; both scale the learning rate by 0 at step 0.

``--layers`` cuts the config's depth (the port's addition: a model's
full training state may not fit one card).

Checkpoint/restart: ``--ckpt-dir`` enables async QUACK-replicated
snapshots every ``--ckpt-every`` steps; ``--restore`` resumes after the
latest one (the data pipeline is deterministic in the step, so the loss
curve continues). Checkpoints share the JAX package's layout and keys.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-8b-smoke --steps 30 --mesh 1x2x2 --mode ddp \\
      --sync picsou --ckpt-dir /tmp/ck --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import torch
from torch.profiler import record_function

from ..checkpoint import CheckpointManager, restore_tree
from ..configs import get_config
from ..configs.base import ShapeSpec
from ..crosspod import (ata_cross_pod_sync, ef_int8_compress,
                        ef_int8_decompress, make_ef_state,
                        picsou_cross_pod_sync)
from ..data import SyntheticTokens
from ..models import init_model
from ..models.params import resolve_device
from ..optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from ..tree_util import tree_flatten, tree_flatten_up_to, tree_unflatten
from .mesh import P, parse_mesh
from .steps import build_train_step, value_and_grad

__all__ = ["TrainRun", "make_step", "run", "main", "parser"]


def _compress(grads, ef):
    """EF-int8 on every leaf: (the dequantised gradients, new residuals)."""
    flat, treedef = tree_flatten(grads)
    outs, new_ef = [], []
    for g, e in zip(flat, tree_flatten_up_to(treedef, ef)):
        packed, ne = ef_int8_compress(g, e)
        outs.append(ef_int8_decompress(packed, g.shape).to(g.dtype))
        new_ef.append(ne)
    return tree_unflatten(treedef, outs), tree_unflatten(treedef, new_ef)


class TrainRun(list):
    """Each step's cross entropy (a list, as the JAX package's ``run``
    returns), with each step's seconds in ``step_s`` (host clock around
    the step and the read of its loss)."""

    step_s: List[float]


def make_step(args, cfg, mesh, shape, params):
    """The step of ``args.mode``: ``(params, opt, batch) -> (params, opt,
    metrics)``; a ddp step keeps its EF-int8 residuals (``params`` with
    ``--compress`` off, as in the JAX package) across calls."""
    opt_cfg = AdamWConfig(lr=args.lr)
    if args.mode == "pjit":
        return build_train_step(cfg, mesh, shape, opt_cfg=opt_cfg)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    ways = 1
    for a in batch_axes:
        ways *= mesh.shape[a]
    if args.batch % ways:
        raise ValueError(f"ddp: the global batch {args.batch} does not "
                         f"split over {batch_axes} ({ways} ways)")
    sync = (picsou_cross_pod_sync if args.sync == "picsou"
            else ata_cross_pod_sync)
    compress = args.compress and "pod" in mesh.shape
    ef = make_ef_state(params) if args.compress else params

    def ddp_step(params, opt, batch):
        nonlocal ef
        (_, metrics), grads = value_and_grad(params, cfg, batch)
        if compress:
            with record_function("train.ef_int8"):
                grads, ef = _compress(grads, ef)
        with record_function("train.sync"):
            grads = sync(grads, mesh, in_specs=P())
        lr = cosine_schedule(opt.step, 10, args.steps * 10)
        with record_function("train.adamw"):
            params, opt = adamw_update(opt_cfg, grads, params, opt, lr)
        return params, opt, metrics

    return ddp_step


def run(args) -> TrainRun:
    """Train ``args.steps`` steps; returns each step's cross entropy."""
    cfg = get_config(args.arch)
    if getattr(args, "layers", 0):
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(getattr(args, "device", None), "training runs")
    mesh = parse_mesh(args.mesh, dev)
    shape = ShapeSpec("train", args.seq, args.batch, "train")
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=17)

    params = init_model(cfg, args.seed, dev)
    opt = adamw_init(params)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, n_shards=4)
        if args.restore:
            (params, opt), start_step = restore_tree((params, opt),
                                                     args.ckpt_dir)
            start_step += 1
            print(f"restored checkpoint, resuming at step {start_step}")
    one_step = make_step(args, cfg, mesh, shape, params)

    losses = TrainRun()
    losses.step_s = []
    for step in range(start_step, start_step + args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        t0 = time.time()
        params, opt, metrics = one_step(params, opt, batch)
        ce = float(metrics["ce"])
        losses.append(ce)
        losses.step_s.append(time.time() - t0)
        print(f"step {step:4d} ce={ce:7.4f} ({losses.step_s[-1]:5.2f}s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step, (params, opt))
    if mgr:
        mgr.wait()
        mgr.close()
    # basic sanity: loss must decrease on synthetic data
    if len(losses) >= 10:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(improved={losses[-1] < losses[0]})")
    return losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b-smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--mode", default="pjit", choices=["pjit", "ddp"])
    ap.add_argument("--sync", default="picsou", choices=["picsou", "ata"])
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers "
                    "(default: the config's own)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' on request)")
    return ap


def main(argv=None) -> TrainRun:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
