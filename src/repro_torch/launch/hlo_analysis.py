"""What the dry-run measures, from a fake-tensor trace of one rank's step.

Counterpart of ``repro.launch.hlo_analysis``, which parses the optimized
HLO of a compiled step. The port has no HLO: it runs the cell's step once
under ``torch._subclasses.fake_tensor.FakeTensorMode`` (every tensor a
shape-and-type stand-in; nothing is allocated on any device and nothing
is computed) as rank 0 of a fake process group, and reads the trace.
``trace`` records it; ``analyze`` / ``memory_stats`` / ``cost_stats``
give the reference's keys where they mean the same thing, per rank:

  * ``flops`` — ``torch.utils.flop_counter.FlopCounterMode``'s count of
    the dispatched matrix products (every layer: the loop runs in Python,
    so nothing is counted once for many trips), plus each hand-written
    kernel's operations, which the kernel wrappers report on fake tensors
    from their modules' ``cost``, the formulas of ``chip_smoke.py``'s
    bounds (``kernels._build.fake_launch``; where the work depends on
    data a trace counts the most it could need: a decode kernel its
    whole cache, ``shed_partition`` every way of every probe);
  * ``hbm_bytes`` — operand and result bytes of every dispatched op that
    is not a view, an allocation or a metadata query, plus the kernels'
    bytes: the eager
    counterpart of the reference's fusion-I/O estimator (an upper bound:
    what a fused kernel keeps on chip is counted as if it went to HBM);
  * ``collective_bytes`` / ``collectives`` / ``collective_counts`` — the
    result bytes of ``distribution.placement``'s collectives by kind,
    backward passes included;
  * ``argument_bytes`` / ``output_bytes`` / ``alias_bytes`` /
    ``temp_bytes`` — the step's local inputs (state and batch), its new
    outputs, its outputs that are inputs updated in place, and the peak
    of its own allocations (``torch.distributed._tools.mem_tracker.
    MemTracker``) less its new outputs.

``cost_stats`` keeps the dispatched ops alone (the kernels' own numbers
left out), as the reference keeps XLA's own count beside its estimator.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "all-to-all", "collective-permute")

# ops that move no data: allocations and aliases
_NO_BYTES = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "set_", "resize_")


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class _OpBytes(TorchDispatchMode):
    """Counts dispatched ops and their operand and result bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not (getattr(func, "is_view", False) or name in _NO_BYTES
                or func.namespace == "prim"):     # metadata queries
            self.n_ops += 1
            self.bytes += sum(_bytes(t) for t in tree_flatten(
                (args, kwargs or {}))[0])
            self.bytes += sum(_bytes(t) for t in tree_flatten(out)[0])
        return out


@dataclass
class Trace:
    """What one fake run of a step recorded (per rank)."""
    flops: float = 0.0                 # dispatched matrix products
    op_bytes: float = 0.0              # dispatched ops' operands + results
    n_ops: int = 0
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    collectives: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    collective_counts: Dict[str, int] = field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    alias_bytes: float = 0.0
    peak_bytes: float = 0.0            # the step's own allocations


def _storages(tree) -> Dict[int, int]:
    """Bytes of each distinct storage of the tensors in ``tree``."""
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            out[id(s) if _fakeish(t) else s.data_ptr()] = s.nbytes()
    return out


def _fakeish(t) -> bool:
    from repro_torch.kernels._build import is_fake
    return is_fake(t) or t.device.type == "meta"


def trace(step: Callable, args: tuple) -> "tuple[Trace, object]":
    """Run ``step(*args)`` once on fake tensors (``args`` made under the
    caller's ``FakeTensorMode``, which must be active) and record it.
    Returns (the trace, the step's output)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distribution.placement import collective_trace
    from repro_torch.kernels._build import kernel_costs

    tr = Trace()
    inputs = _storages(args)
    tr.argument_bytes = float(sum(inputs.values()))

    def on_collective(kind: str, nbytes: int) -> None:
        tr.collectives[kind] += nbytes
        tr.collective_counts[kind] += 1

    def on_kernel(name: str, flops: float, nbytes: float) -> None:
        k = tr.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                         "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    ops = _OpBytes()
    mem = MemTracker()
    with contextlib.ExitStack() as stack:
        stack.enter_context(collective_trace(on_collective))
        stack.enter_context(kernel_costs(on_kernel))
        stack.enter_context(mem)
        fc = stack.enter_context(FlopCounterMode(display=False))
        stack.enter_context(ops)
        out = step(*args)
    tr.flops = float(fc.get_total_flops())
    tr.op_bytes = float(ops.bytes)
    tr.n_ops = ops.n_ops
    outputs = _storages(out)
    tr.alias_bytes = float(sum(b for s, b in outputs.items() if s in inputs))
    tr.output_bytes = float(sum(b for s, b in outputs.items()
                                if s not in inputs))
    peak = mem.get_tracker_snapshot("peak")
    tr.peak_bytes = float(max((v.get("Total", 0) for v in peak.values()),
                              default=0))
    return tr, out


def analyze(tr: Trace) -> Dict[str, float]:
    """flops, hbm bytes and collective bytes of one rank's step, the
    kernels' own numbers included."""
    return {
        "flops": tr.flops + sum(k["flops"] for k in tr.kernels.values()),
        "hbm_bytes": tr.op_bytes + sum(k["bytes"]
                                       for k in tr.kernels.values()),
        "collective_bytes": sum(tr.collectives.values()),
        "collectives": dict(tr.collectives),
        "collective_counts": dict(tr.collective_counts),
        "kernels": {n: dict(k) for n, k in tr.kernels.items()},
        "n_ops": tr.n_ops,
    }


def memory_stats(tr: Trace) -> Dict[str, float]:
    return {
        "argument_bytes": tr.argument_bytes,
        "output_bytes": tr.output_bytes,
        "temp_bytes": max(tr.peak_bytes - tr.output_bytes, 0.0),
        "alias_bytes": tr.alias_bytes,
        "peak_bytes": tr.peak_bytes,
    }


def cost_stats(tr: Trace) -> Dict[str, float]:
    """The dispatched ops alone (the kernels' numbers left out)."""
    return {"flops": tr.flops, "bytes_accessed": tr.op_bytes}
