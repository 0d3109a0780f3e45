"""Batched greedy decode serving launcher.

Prefills a batch of prompts (eagerly), then decodes tokens step by step
with the ring-buffer KV caches through ``launch.steps.decode``, the
decode step as the JAX launcher jits it: on the card one captured CUDA
graph replayed a step, its caches donated (on the CPU the same body,
eagerly). Prints the prefill time, ms per decode step and tokens/s.
Runs on the card unless ``--device`` names another:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --batch 4 --prompt-len 512 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-8b-smoke --device cpu

Times are host clocks around work that ends in a device synchronise.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import numpy as np
import torch

from ..configs import ModelConfig, get_config
from ..data import SyntheticTokens
from ..models import init_model, prefill
from ..models.params import resolve_device
from .mesh import parse_mesh
from .steps import decode

__all__ = ["Generation", "generate", "run", "main"]


@dataclasses.dataclass
class Generation:
    """Greedy tokens (B, 1 + gen): prefill's argmax, then one a step;
    prefill seconds and each decode step's seconds."""

    tokens: np.ndarray
    prefill_s: float
    step_s: List[float]

    @property
    def steady_s(self) -> float:
        """Mean step time, the first step left out when there are more."""
        return float(np.mean(self.step_s[1:] or self.step_s))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, gen: int,
             memory=None) -> Generation:
    """Prefill ``prompts`` (B, P) and decode ``gen`` tokens greedily on the
    prompts' device, printing as the JAX package's launcher does."""
    dev = prompts.device
    b, plen = prompts.shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, prompts, memory=memory,
                             cache_len=plen + gen)
    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    print(f"prefill: {prefill_s:.2f}s for {b}x{plen}")
    out_tokens, times = [tok], []
    for i in range(gen):
        t0 = time.perf_counter()
        logits, caches = decode(params, cfg, caches, tok, plen + i)
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        out_tokens.append(tok)
    res = Generation(torch.cat(out_tokens, dim=1).cpu().numpy(), prefill_s,
                     times)
    print(f"decode: {res.steady_s * 1e3:.1f} ms/step, "
          f"{b / res.steady_s:.1f} tok/s aggregate")
    print("sample:", res.tokens[0][:12].tolist())
    return res


def run(args) -> np.ndarray:
    cfg = get_config(args.arch)
    dev = resolve_device(args.device)
    parse_mesh(args.mesh, dev)              # parsed, as in the JAX launcher
    params = init_model(cfg, args.seed, dev)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.prompt_len,
                           global_batch=args.batch, seed=3)
    prompts = torch.from_numpy(data.batch_at(0)["tokens"]).to(dev)
    memory = None
    if cfg.family in ("encdec", "vlm"):
        mem = cfg.encoder_seq if cfg.family == "encdec" else cfg.vision_seq
        memory = torch.zeros((args.batch, mem, cfg.d_model),
                             dtype=torch.float32, device=dev)
    return generate(params, cfg, prompts, args.gen, memory).tokens


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' on request)")
    return ap


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
