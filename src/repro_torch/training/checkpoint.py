"""Fault-tolerant checkpointing: atomic saves, manifests, integrity
checks and retention.

Counterpart of ``repro.training.checkpoint``, with its on-disk layout:

    <dir>/step_<N>/
        manifest.json   - step, extra, leaf paths, shapes, dtypes, sha256
        leaves_<i>.npz  - up to 64 leaf payloads each
    <dir>/LATEST        - atomic pointer (written last)

Writes go to ``step_<N>.tmp`` and are renamed only after fsync, so a
crash mid-save leaves the previous checkpoint whole; a checksum mismatch
on restore raises ``IOError``. Leaves are saved unsharded, in JAX's leaf
order. ``restore`` places the leaves on a ``device`` (or each on its
``tree_like`` leaf's); elastic re-sharding onto another mesh
(``shardings=``) waits for the distribution slice.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.tree import leaves, leaves_with_paths, unflatten

_LEAVES_PER_FILE = 64


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict] = None, keep_last: int = 3) -> str:
    """Atomic checkpoint save. Returns the final checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    pairs = leaves_with_paths(tree)
    paths = [p for p, _ in pairs]
    host_leaves = [_host(leaf) for _, leaf in pairs]

    manifest: Dict[str, Any] = {
        "step": step, "extra": extra or {},
        "leaves": [], "n_files": 0,
    }
    for fi in range(0, len(host_leaves), _LEAVES_PER_FILE):
        chunk = host_leaves[fi:fi + _LEAVES_PER_FILE]
        fname = f"leaves_{fi // _LEAVES_PER_FILE:04d}.npz"
        fpath = os.path.join(tmp, fname)
        np.savez(fpath, **{f"a{j}": a for j, a in enumerate(chunk)})
        with open(fpath, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        for j, (a, p) in enumerate(zip(chunk, paths[fi:fi + len(chunk)])):
            manifest["leaves"].append({
                "path": p, "file": fname, "key": f"a{j}",
                "shape": list(a.shape), "dtype": str(a.dtype),
            })
        manifest.setdefault("files", {})[fname] = digest
        manifest["n_files"] += 1

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)

    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    _retain(ckpt_dir, keep_last)
    return final


def _retain(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            verify: bool = True, device=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (a tree of tensors),
    each leaf in its ``tree_like`` leaf's dtype, on ``device`` or, when
    none is given, on that leaf's device. Returns (tree, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)

    if verify:
        for fname, digest in manifest.get("files", {}).items():
            with open(os.path.join(final, fname), "rb") as f:
                got = hashlib.sha256(f.read()).hexdigest()
            if got != digest:
                raise IOError(f"checkpoint corrupt: {fname} checksum "
                              f"mismatch at step {step}")

    cache: Dict[str, Any] = {}
    host_leaves = []
    for entry in manifest["leaves"]:
        if entry["file"] not in cache:
            cache[entry["file"]] = np.load(os.path.join(final,
                                                        entry["file"]))
        host_leaves.append(cache[entry["file"]][entry["key"]])

    ref_leaves = leaves(tree_like)
    if len(ref_leaves) != len(host_leaves):
        raise ValueError(
            f"checkpoint has {len(host_leaves)} leaves, expected "
            f"{len(ref_leaves)}: structure mismatch")
    out_leaves = []
    for ref, arr in zip(ref_leaves, host_leaves):
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf shape mismatch: ckpt {arr.shape} vs "
                             f"model {tuple(ref.shape)}")
        out_leaves.append(torch.as_tensor(arr).to(
            device=device if device is not None else ref.device,
            dtype=ref.dtype))
    return unflatten(tree_like, out_leaves), manifest["extra"]


class AsyncCheckpointer:
    """Background-thread writer so training never blocks on I/O.

    ``save`` copies the tree to host memory synchronously and writes it
    on a worker thread; ``wait`` joins it and raises a worker's error.
    """

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             extra: Optional[Dict] = None) -> None:
        self.wait()
        host_tree = unflatten(tree, [_host(leaf) for leaf in leaves(tree)])

        def _run():
            try:
                save(self.ckpt_dir, step, host_tree, extra,
                     self.keep_last)
            except BaseException as e:   # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
