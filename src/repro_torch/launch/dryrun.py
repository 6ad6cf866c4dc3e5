"""Multi-pod dry-run: trace every (architecture × input-shape) cell's step
on the production meshes and record its per-rank FLOPs, bytes, collective
bytes and memory for the roofline.

Counterpart of ``repro.launch.dryrun``. Nothing is allocated on any
device and nothing is computed: the process joins a fake process group of
256 ranks (``--mesh single``: (data=16, model=16)) or 512 (``multi``:
(pod=2, data=16, model=16)) as rank 0, builds the cell
(``launch.steps.build_cell``), makes rank 0's pieces of its inputs as
fake tensors (``FakeTensorMode``) and runs the step once, which
``launch.hlo_analysis`` reads. The fake tensors say ``cuda`` where torch
is built with CUDA; a torch built without it cannot hold fake CUDA
tensors in autograd, and there they say ``cpu``. The kernel wrappers take
their fake branch on any fake tensor (no launch; their operations and
bytes reported), so the hand-written kernels are on the traced route
either way. Run it as a fresh process (``python -m
repro_torch.launch.dryrun``): the fake group must not meet a real one.

Usage:
  python -m repro_torch.launch.dryrun --mesh single       # 16x16 = 256
  python -m repro_torch.launch.dryrun --mesh multi        # 2x16x16 = 512
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all               # both meshes

Artifacts: artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json (the
reference's record; ``trace_s`` stands in for ``lower_s`` /
``compile_s``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Optional, Tuple

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def trace_device() -> str:
    """``cuda`` where torch is built with CUDA, else ``cpu`` (see the
    module note)."""
    import torch
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def fake_world(shape: Tuple[int, ...], axes: Tuple[str, ...], device: str):
    """Rank 0 of a fake process group of prod(shape) ranks, and its
    mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = int(np.prod(shape))
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def trace_cell(cell, mesh, device: str):
    """(hlo_analysis.Trace, seconds) of one fake run of ``cell``'s step
    on ``mesh``'s rank 0."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch import steps as ST

    t0 = time.time()
    with FakeTensorMode():
        args = ST.local_abstract(cell, mesh, device)
        tr, _ = HA.trace(cell.step_fn, args)
    return tr, time.time() - t0


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str,
             variant: str = "", mesh=None, cfg=None, shape=None,
             device: Optional[str] = None) -> dict:
    """Trace one cell and write its record. ``mesh`` (a fake-group mesh)
    defaults to the production mesh of ``mesh_kind``; ``cfg`` / ``shape``
    replace the registry's (a smoke-width trace)."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch import steps as ST

    device = device or trace_device()
    if mesh is None:
        mesh = fake_world(*MESHES[mesh_kind], device)
    n_dev = mesh.size()
    if cfg is None and shape is None:
        cell = ST.build_cell(arch_id, shape_name, mesh, variant=variant)
    else:
        b = get_bundle(arch_id)
        shape = shape or next(s for s in b.shapes if s.name == shape_name)
        cell = ST.cell_of(cfg or b.config, shape, mesh, arch_id)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
           "n_devices": int(n_dev), "kind": cell.shape.kind,
           "loop_multiplier": cell.loop_multiplier,
           "n_params": cell.meta["n_params"],
           "n_active_params": cell.meta["n_active_params"],
           "useful_flops_fwd": cell.meta.get("useful_flops_fwd", 0.0),
           "tokens": cell.meta["tokens"], "trace_device": device,
           "ok": False}
    launches = _launches()
    try:
        tr, secs = trace_cell(cell, mesh, device)
        rec.update({
            "ok": True,
            "trace_s": round(secs, 2),
            "memory": HA.memory_stats(tr),
            "cost": HA.cost_stats(tr),
            "analysis": HA.analyze(tr),
        })
    except Exception as e:  # record the failure for triage
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        rec["kernel_launches"] = {k: n - launches[k]
                                  for k, n in _launches().items()}
        suffix = f"@{variant}" if variant else ""
        path = os.path.join(out_dir,
                            f"{arch_id}__{shape_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')})"
    print(f"[{mesh_kind}] {arch_id} x {shape_name}{suffix}: {status} "
          f"(trace {rec.get('trace_s', '-')}s)", flush=True)
    return rec


def _launches() -> dict:
    """Every hand-written kernel's launch counter (a fake trace leaves
    them as they were)."""
    import repro_torch.core  # noqa: F401 (before shed_partition: a cycle)
    from repro_torch.kernels import (dot_interaction, flash_attention,
                                     flash_decode, shed_partition,
                                     topk_select)
    ws = (shed_partition.shed_partition, flash_attention.flash_attention,
          flash_attention.flash_attention_bwd, topk_select.topk_select,
          dot_interaction.dot_interaction,
          dot_interaction.dot_interaction_bwd, flash_decode.flash_decode)
    return {w.__name__: w.launches for w in ws}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Trace every (arch x shape) cell's step on the "
        "production mesh as rank 0 of a fake process group, on fake "
        "tensors: nothing is allocated on any device and nothing is "
        "computed. Writes artifacts/dryrun_torch/<mesh>/<arch>__<shape>"
        ".json.")
    p.add_argument("--mesh", choices=["single", "multi"],
                   default="single")
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true",
                   help="run all cells on both meshes")
    p.add_argument("--skip-done", action="store_true")
    p.add_argument("--variant", default="",
                   help="config variant (steps.VARIANTS)")
    p.add_argument("--out", default=None,
                   help="artifact root (default artifacts/dryrun_torch)")
    args = p.parse_args(argv)

    from repro_torch.launch import steps as ST

    meshes = ["single", "multi"] if args.all else [args.mesh]
    cells = ST.all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]

    n_fail = 0
    t0 = time.time()
    for mesh_kind in meshes:
        out_dir = os.path.abspath(os.path.join(args.out or ART_DIR,
                                               mesh_kind))
        os.makedirs(out_dir, exist_ok=True)
        mesh = fake_world(*MESHES[mesh_kind], trace_device())
        for arch_id, shape_name in cells:
            suffix = f"@{args.variant}" if args.variant else ""
            path = os.path.join(out_dir,
                                f"{arch_id}__{shape_name}{suffix}.json")
            if args.skip_done and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        continue
            rec = run_cell(arch_id, shape_name, mesh_kind, out_dir,
                           variant=args.variant, mesh=mesh)
            n_fail += 0 if rec["ok"] else 1
    print(f"dry-run complete: {n_fail} failures "
          f"({time.time() - t0:.1f} s)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
