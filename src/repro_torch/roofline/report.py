"""Render the dry-run results JSONL into the roofline tables.

  PYTHONPATH=src python -m repro_torch.roofline.report \
      dryrun_torch_results.jsonl

The same table as the JAX package's ``repro.roofline.report``, from the
same record keys, so either package's results file renders here.
"""

from __future__ import annotations

import json
import sys
from collections import OrderedDict

ARCH_ORDER = ["granite-34b", "qwen2-72b", "granite-8b", "starcoder2-3b",
              "hymba-1.5b", "deepseek-moe-16b", "mixtral-8x22b", "rwkv6-7b",
              "whisper-small", "llama-3.2-vision-11b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(path: str, mesh: str = "single", tag: str = ""):
    best = OrderedDict()
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("mesh") != mesh or r.get("tag", "") != tag:
                continue
            best[(r["arch"], r["shape"], r.get("impl", "scan"))] = r
    return best


def fmt_row(r):
    blank = "— | — | — | — | —"
    if r["status"] == "SKIP":
        return (f"| {r['arch']} | {r['shape']} | SKIP | {blank} | "
                f"{r['reason']} |")
    if r["status"] != "OK":
        return (f"| {r['arch']} | {r['shape']} | FAIL | {blank} | "
                f"{r.get('error', '')[:60]} |")
    dom = r["bottleneck"]
    total = max(r["compute_s"], r["memory_s"], r["collective_s"])
    frac = r["compute_s"] / total if total > 0 else 0.0
    return (f"| {r['arch']} | {r['shape']} | {r['status']} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | **{dom}** "
            f"| {r['useful_ratio']:.3f} | roofline-frac={frac:.2f} |")


def table(path: str, mesh: str, impl: str = "scan", tag: str = ""):
    rows = load(path, mesh, tag)
    out = ["| arch | shape | status | compute_s | memory_s | collective_s "
           "| bottleneck | useful | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = rows.get((arch, shape, impl))
            if r is None:
                continue
            out.append(fmt_row(r))
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_torch_results.jsonl"
    mesh = sys.argv[2] if len(sys.argv) > 2 else "single"
    impl = sys.argv[3] if len(sys.argv) > 3 else "scan"
    tag = sys.argv[4] if len(sys.argv) > 4 else ""
    print(table(path, mesh, impl, tag))


if __name__ == "__main__":
    main()
