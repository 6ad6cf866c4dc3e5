"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Also ``refuse_grad``: the wrappers whose kernels have no backward raise
rather than return a result detached from autograd; and ``is_fake`` /
``fake_launch``: a wrapper given fake CUDA tensors (a
``FakeTensorMode`` trace, ``launch.hlo_analysis``) launches nothing,
returns fake outputs of the kernel's shapes and types, and reports the
kernel's operations and bytes (its module's ``cost``, the formulas of
its bound) to ``kernel_costs``. A wrapper makes the checks of a launch
first, so a trace refuses what a launch refuses. Only a ``FakeTensor``
takes that branch: a real CUDA tensor launches the kernel or raises.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/lib<name>-<source hash>.so`` inside the package
directory (listed in ``.gitignore``); the hash covers the ``.cu`` and
every header it includes with ``#include "..."``. A library is built on
first use; ``build`` starts one ``nvcc`` per missing library, all at
once. Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], Callable] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _source_files(path: Path, seen: List[Path]) -> List[Path]:
    """``path`` and, depth first, every file it includes with
    ``#include "..."`` that exists beside it, each once."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
        header = path.parent / inc.decode()
        if header.exists():
            _source_files(header.resolve(), seen)
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _source_files((CSRC / f"{name}.cu").resolve(), []):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    each, all started together. Returns the compiler's diagnostics per
    compiled name (``-Xptxas -v``: registers, shared memory, spills).
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                          f"{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through kernel ``name``,
    which has none: on CUDA its output would carry no ``grad_fn`` and a
    ``backward()`` would silently give its inputs no gradient."""
    import torch
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if isinstance(t, torch.Tensor)):
        raise RuntimeError(f"{name} has no backward kernel: call it under "
                           f"torch.no_grad() or with inputs that do not "
                           f"require grad")


def library_function(name: str, symbol: str, argtypes: List,
                     restype=ctypes.c_int) -> Callable:
    """``symbol`` of ``csrc/<name>.cu`` with its argument types declared
    (pointers and the stream as ``c_void_p``) and its result type (an
    ``int`` error code unless named)."""
    key = (name, symbol)
    if key not in _functions:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _functions[key] = fn
    return _functions[key]


def is_fake(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``FakeTensor`` (a shape-and-type
    stand-in that holds no memory); False for every real tensor, and
    without importing the fake-tensor module in a process that made
    none."""
    mod = sys.modules.get("torch._subclasses.fake_tensor")
    return mod is not None and any(isinstance(t, mod.FakeTensor)
                                   for t in tensors)


def misaligned(t: torch.Tensor, n: int = 16) -> bool:
    """Whether ``t``'s first element is off an ``n``-byte boundary: its
    address for a real tensor; for a fake one, which has none, its byte
    offset into its storage (a storage starts aligned)."""
    if is_fake(t):
        return (t.storage_offset() * t.element_size()) % n != 0
    return t.data_ptr() % n != 0


# the ``kernel_costs`` callback: a process-wide slot, not a context
# variable, so that a backward pass on autograd's own thread reports too
_COSTS: List[Callable] = []


@contextlib.contextmanager
def kernel_costs(note):
    """Call ``note(name, flops, bytes)`` for every kernel call on fake
    tensors in the ``with`` block, on any thread."""
    _COSTS.append(note)
    try:
        yield
    finally:
        _COSTS.remove(note)


def fake_launch(name: str, flops: float, nbytes: float) -> None:
    """What a kernel would cost, reported in place of a launch."""
    if _COSTS:
        _COSTS[-1](name, float(flops), float(nbytes))
