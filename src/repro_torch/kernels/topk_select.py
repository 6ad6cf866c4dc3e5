"""Top-k of a dense score vector by (score desc, index asc).

Counterpart of ``repro.kernels.topk_select``: the retrieval hot op. BM25
produces a dense (N,) score vector per query (one slot per shard
document) and the candidate set is its top-k in the same total order
the pure-Python postings scorer produces, ties included.

``topk_select`` launches the hand-written CUDA kernel
(``csrc/topk_select.cu``, replacing the TPU kernel ``_topk_kernel``: an
exact radix select on the score images in one launch of one
thread-block cluster, whose CTAs merge their digit histograms through
distributed shared memory and take the ties at the threshold by an
ordered compaction; bound by bytes, N*4 + k*8 in float32) for CUDA
tensors, and takes the plain version ``topk_select_ref`` only for CPU
tensors. Any ``1 <= k <= N`` is accepted on both, in float32 (the TPU
kernel's type) or float64 (the type retrieval ranks in, see
``retrieval.shard``).

Both treat -0.0 and +0.0 as equal scores (the tie breaks by index, as
the reference oracle's sort of negated scores does) and return the
input's own values, signed zeros included.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import (fake_launch, is_fake,
                                        library_function, refuse_grad)

_DTYPES = {torch.float32: 0, torch.float64: 1}
NEG_INF = -2.0e38
INT32_MAX = 2 ** 31 - 1
# As csrc/topk_select.cu: keys a sort tile holds (the cluster path takes
# N > TILE and k <= TILE / 2), and the bytes of score images a CTA of the
# cluster stages in shared memory.
TILE = {torch.float32: 4096, torch.float64: 2048}
STAGE_BYTES = 160 * 1024


def staged_capacity(dtype: torch.dtype) -> int:
    """The largest N whose chunks a cluster of 8 CTAs stages in shared
    memory (images are as wide as the scores); past it the cluster has
    16 CTAs, which stage their chunks up to twice this N."""
    return 8 * (STAGE_BYTES // torch.empty(0, dtype=dtype).element_size())


def topk_select_ref(scores: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (the reference's ``kernels.ref.topk_select_ref``): a
    stable sort of the negated scores, after ``-0.0 -> +0.0``, keeps
    equal scores in index order."""
    n = scores.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    canon = torch.where(scores == 0, torch.zeros_like(scores), scores)
    order = torch.sort(-canon, stable=True).indices[:k]
    return scores[order], order.to(torch.int32)


def cost(n: int, k: int, size: int):
    """(operations, bytes) of one call: the N scores read once, k values
    and their int32 indices written. A select compares; no arithmetic is
    counted."""
    return 0, n * size + k * (size + 4)


def topk_select(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores: (N,) float32 or float64, contiguous; 1 <= k <= N.

    Returns ``(values (k,) in the scores' type, indices (k,) int32)``
    ordered by (score desc, index asc). CUDA tensors launch the kernel
    (counted in ``topk_select.launches``, once per call); CPU tensors
    take the plain version.
    """
    if scores.dim() != 1:
        raise ValueError(f"scores must be (N,), got {tuple(scores.shape)}")
    if scores.dtype not in _DTYPES:
        raise TypeError(f"scores must be float32 or float64, got "
                        f"{scores.dtype}")
    n = scores.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if scores.device.type == "cpu" and not is_fake(scores):
        return topk_select_ref(scores, k)
    if scores.device.type != "cuda" and not is_fake(scores):
        raise ValueError(f"topk_select runs on cuda or cpu, "
                         f"not {scores.device}")
    refuse_grad("topk_select", scores)
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    if n > INT32_MAX:
        raise ValueError(f"topk_select indexes with int32: N={n} is too "
                         f"large")
    if is_fake(scores):
        fake_launch("topk_select", *cost(n, k, scores.element_size()))
        return (torch.empty(k, dtype=scores.dtype, device=scores.device),
                torch.empty(k, dtype=torch.int32, device=scores.device))
    dtype = _DTYPES[scores.dtype]
    n_bytes = library_function(
        "topk_select", "topk_select_scratch_bytes",
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
        restype=ctypes.c_longlong)(n, k, dtype)
    fn = library_function(
        "topk_select", "topk_select_launch",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    dev = scores.device
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
    vals = torch.empty(k, dtype=scores.dtype, device=dev)
    idxs = torch.empty(k, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(scores.data_ptr(), n, int(k), dtype, scratch.data_ptr(),
             vals.data_ptr(), idxs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk_select kernel launch failed: "
                           f"cudaError {err}")
    topk_select.launches += 1
    return vals, idxs


def launch_floor(device) -> None:
    """Launch an empty kernel through the same ctypes route: the card's
    launch floor, the least time any launch of this kernel can take."""
    err = library_function("topk_select", "topk_select_launch_floor",
                           [ctypes.c_void_p])(
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")


topk_select.launches = 0
