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
order: a DTensor leaf is gathered whole first (every rank of its mesh
calls ``save``; global rank 0 writes), one leaf at a time, so that no
rank holds the whole state on its host. ``restore`` places the leaves on
a ``device`` (or each on its ``tree_like`` leaf's), or, elastic, with
``shardings=`` (a tree of ``distribution.placement.NamedSharding``
matching ``tree_like``) as DTensors of those shardings: each rank keeps
its own pieces of the saved values, on a mesh other than the one that
saved them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.tree import leaves, leaves_with_paths, unflatten

_LEAVES_PER_FILE = 64


def _host(leaf: Any, keep: bool = True) -> Optional[np.ndarray]:
    """A leaf's whole value on the host. A DTensor leaf is gathered (every
    rank of its mesh must call this, leaf by leaf in one order); with
    ``keep`` false the gathered value is dropped at once and None
    returned (a rank that does not write)."""
    from repro_torch.distribution.placement import full_tensor, is_dtensor
    if is_dtensor(leaf):
        leaf = full_tensor(leaf)
    if not keep:
        return None
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _writer() -> bool:
    """Whether this process writes: global rank 0, or no process
    group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict] = None, keep_last: int = 3) -> str:
    """Atomic checkpoint save. Returns the final checkpoint path. With a
    process group of several ranks, every rank calls it (a DTensor leaf
    is gathered), rank 0 writes, and all return once it has. Leaves
    stream: one leaf at a time is gathered, copied to the writer's host
    and written, and no other rank keeps a copy."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    pairs = leaves_with_paths(tree)
    writer = _writer()
    host = (_host(leaf, writer) for _, leaf in pairs)
    if writer:
        _write(ckpt_dir, final, step, [p for p, _ in pairs], host, extra,
               keep_last)
    else:
        for _ in host:                   # join each leaf's gather
            pass
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return final


def _write(ckpt_dir: str, final: str, step: int, paths, host_leaves,
           extra: Optional[Dict], keep_last: int) -> None:
    """Write the leaves of the iterable ``host_leaves`` (in ``paths``'
    order) one at a time into ``np.savez``'s format, ``_LEAVES_PER_FILE``
    to a file, then the manifest and the pointer."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {
        "step": step, "extra": extra or {},
        "leaves": [], "n_files": 0,
    }
    zf, fname = None, None
    for i, (p, a) in enumerate(zip(paths, host_leaves)):
        j = i % _LEAVES_PER_FILE
        if j == 0:
            if zf is not None:
                _close(zf, tmp, fname, manifest)
            fname = f"leaves_{i // _LEAVES_PER_FILE:04d}.npz"
            zf = zipfile.ZipFile(os.path.join(tmp, fname), "w",
                                 compression=zipfile.ZIP_STORED,
                                 allowZip64=True)
        with zf.open(f"a{j}.npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.asanyarray(a),
                                      allow_pickle=False)
        manifest["leaves"].append({
            "path": p, "file": fname, "key": f"a{j}",
            "shape": list(np.shape(a)), "dtype": str(np.asanyarray(a).dtype),
        })
        del a
    if zf is not None:
        _close(zf, tmp, fname, manifest)

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


def _close(zf: zipfile.ZipFile, tmp: str, fname: str,
           manifest: Dict[str, Any]) -> None:
    """Close one leaves file and enter its checksum."""
    zf.close()
    manifest.setdefault("files", {})[fname] = _sha256(
        os.path.join(tmp, fname))
    manifest["n_files"] += 1


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
            verify: bool = True, shardings: Any = None,
            device=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (a tree of tensors, or
    of anything with a ``shape`` and ``dtype``), each leaf in its
    ``tree_like`` leaf's dtype, on ``device`` or, when none is given, on
    that leaf's device. Elastic: with ``shardings`` (a tree of
    ``NamedSharding`` matching ``tree_like``) each leaf is placed as a
    DTensor of its sharding (``placement.device_put``: this rank's
    pieces only, on ``device``) — onto a mesh other than the one that
    saved. Returns (tree, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)

    if verify:
        for fname, digest in manifest.get("files", {}).items():
            if _sha256(os.path.join(final, fname)) != digest:
                raise IOError(f"checkpoint corrupt: {fname} checksum "
                              f"mismatch at step {step}")

    ref_leaves = leaves(tree_like)
    if len(ref_leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected "
            f"{len(ref_leaves)}: structure mismatch")
    from repro_torch.distribution.placement import (NamedSharding,
                                                    device_put)
    shard_leaves = ([None] * len(ref_leaves) if shardings is None else
                    leaves(shardings, is_leaf=lambda s: isinstance(
                        s, NamedSharding)))
    # one leaf at a time is read, placed and dropped from the host
    files: Dict[str, Any] = {}
    out_leaves = []
    for entry, ref, sh in zip(manifest["leaves"], ref_leaves, shard_leaves):
        if entry["file"] not in files:
            files[entry["file"]] = np.load(os.path.join(final,
                                                        entry["file"]))
        arr = files[entry["file"]][entry["key"]]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf shape mismatch: ckpt {arr.shape} vs "
                             f"model {tuple(ref.shape)}")
        a = torch.as_tensor(arr).to(ref.dtype)
        dev = device if device is not None else ref.device
        out_leaves.append(a.to(dev) if sh is None
                          else device_put(a, sh, dev))
        del arr, a
    for f in files.values():
        f.close()
    return unflatten(tree_like, out_leaves), manifest["extra"]


class AsyncCheckpointer:
    """Background-thread writer so training never blocks on I/O.

    ``save`` copies the tree to host memory synchronously and writes it
    on a worker thread; ``wait`` joins it and raises a worker's error.
    With a process group every rank calls ``save`` (a DTensor leaf is
    gathered); only the writer keeps the host copy and writes it.
    """

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             extra: Optional[Dict] = None) -> None:
        self.wait()
        pairs = leaves_with_paths(tree)
        writer = _writer()
        host = [_host(leaf, writer) for _, leaf in pairs]
        if not writer:
            return
        final = os.path.join(self.ckpt_dir, f"step_{step:08d}")

        def _run():
            try:
                _write(self.ckpt_dir, final, step, [p for p, _ in pairs],
                       host, extra, self.keep_last)
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
