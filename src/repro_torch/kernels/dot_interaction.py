"""DLRM dot interaction: the strict upper triangle of each sample's Gram.

Counterpart of ``repro.kernels.dot_interaction``. For (B, F, D) features
it returns (B, F(F-1)/2): entry p is ``x[b, i] . x[b, j]`` for the p-th
pair of ``np.triu_indices(F, 1)``, summed in float32 and returned in the
input's type, without storing the (B, F, F) Gram.

``dot_interaction`` launches the hand-written CUDA kernel
(``csrc/dot_interaction.cu``, replacing the TPU kernel
``_dot_int_kernel``, whose selection-matrix GEMM becomes a direct store
of each Gram entry to its triangle index; a persistent grid whose
blocks request the next groups of samples with bulk asynchronous copies
while they compute the current one on the tensor cores, float32 split
into three TF32 products, hi*hi + hi*lo + lo*hi; bound by
bytes, B*F*D reads and B*F(F-1)/2 writes) for CUDA tensors, and takes
the plain version ``dot_interaction_ref`` only for CPU tensors. Both
take float32 or bfloat16.

Its gradient: dx[b, i] = sum over j != i of g[b, pair(i, j)] x[b, j].
Where grad is enabled and the features require it, a CUDA call goes
through ``DotInteractionFn``, whose backward launches
``dot_interaction_bwd`` (``csrc/dot_interaction_bwd.cu``; plain version
``dot_interaction_bwd_ref``). The JAX package differentiates its einsum
and triangle gather with ``jax.grad``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels._build import (fake_launch, is_fake,
                                        library_function, refuse_grad)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232_448            # an H100 block's shared memory


def triu_pairs(n_f: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``np.triu_indices(n_f, 1)`` as int64 tensors on ``device``."""
    iu, ju = np.triu_indices(n_f, k=1)
    return (torch.as_tensor(iu, device=device),
            torch.as_tensor(ju, device=device))


def dot_interaction_ref(feats: torch.Tensor) -> torch.Tensor:
    """Plain version (the reference's ``kernels.ref.dot_interaction_ref``):
    the full float32 Gram, then the triangle gather."""
    x = feats.to(torch.float32)
    z = torch.bmm(x, x.transpose(1, 2))
    iu, ju = triu_pairs(feats.shape[1], feats.device)
    return z[:, iu, ju].to(feats.dtype)


def dot_interaction_bwd_ref(feats: torch.Tensor,
                            grad: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward: the triangle's gradient ``grad``
    (B, F(F-1)/2) scattered into a symmetric (B, F, F) matrix with a zero
    diagonal, times the features, in float32; returned in feats' type."""
    B, n_f, _ = feats.shape
    iu, ju = triu_pairs(n_f, feats.device)
    gm = torch.zeros((B, n_f, n_f), dtype=torch.float32, device=feats.device)
    gm[:, iu, ju] = grad.to(torch.float32)
    gm = gm + gm.transpose(1, 2)
    return torch.bmm(gm, feats.to(torch.float32)).to(feats.dtype)


def cost(B: int, F: int, D: int, size: int, backward: bool = False):
    """(operations, bytes) of one call. The forward: the F(F-1)/2 pairs'
    dot products of D (2 D operations each), the features read and the
    triangle written. The backward: each pair's gradient times both of
    its rows, the features and the triangle's gradient read and dx
    written."""
    n_pairs = F * (F - 1) // 2
    if backward:
        return 4 * B * n_pairs * D, (2 * B * F * D + B * n_pairs) * size
    return 2 * B * n_pairs * D, (B * F * D + B * n_pairs) * size


def _check(feats: torch.Tensor) -> None:
    if feats.dim() != 3:
        raise ValueError(f"feats must be (B, F, D), got "
                         f"{tuple(feats.shape)}")
    if feats.dtype not in _DTYPES:
        raise TypeError(f"dot_interaction takes float32 or bfloat16, got "
                        f"{feats.dtype}")
    if feats.device.type not in ("cpu", "cuda") and not is_fake(feats):
        raise ValueError(f"dot_interaction runs on cuda or cpu, not "
                         f"{feats.device}")


def _forward(feats: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel."""
    B, F, D = feats.shape
    if not feats.is_contiguous():
        raise ValueError("feats must be contiguous")
    if B > 2 ** 31 - 1:
        raise ValueError(f"dot_interaction indexes blocks with int32: "
                         f"B={B} is too large")
    if is_fake(feats):
        fake_launch("dot_interaction", *cost(B, F, D, feats.element_size()))
        return torch.empty((B, F * (F - 1) // 2), dtype=feats.dtype,
                           device=feats.device)
    # the shared memory a block needs comes from the built library, which
    # a trace does not have: the one launch check it cannot make
    smem = library_function("dot_interaction", "dot_interaction_smem_bytes",
                            [ctypes.c_int] * 3,
                            restype=ctypes.c_longlong)(
        F, D, _DTYPES[feats.dtype])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"dot_interaction: F={F}, D={D} needs {smem} B of "
                         f"shared memory, more than a block has")
    fn = library_function(
        "dot_interaction", "dot_interaction_launch",
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    out = torch.empty((B, F * (F - 1) // 2), dtype=feats.dtype,
                      device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = fn(feats.data_ptr(), out.data_ptr(), B, F, D, _DTYPES[feats.dtype],
             stream)
    if err != 0:
        raise RuntimeError(f"dot_interaction kernel launch failed: "
                           f"cudaError {err}")
    dot_interaction.launches += 1
    return out


class DotInteractionFn(torch.autograd.Function):
    """The forward kernel and ``dot_interaction_bwd`` as one
    differentiable op on CUDA tensors."""

    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        return _forward(feats)

    @staticmethod
    def backward(ctx, grad):
        feats, = ctx.saved_tensors
        return dot_interaction_bwd(feats, grad.contiguous())


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """feats: (B, F, D) float32 or bfloat16 -> (B, F(F-1)/2), same type.

    CUDA tensors launch the kernel (counted in
    ``dot_interaction.launches``), through ``DotInteractionFn`` where
    grad is enabled and the features require it; CPU tensors take the
    plain version (and autograd differentiates it).
    """
    _check(feats)
    if feats.device.type == "cpu" and not is_fake(feats):
        return dot_interaction_ref(feats)
    if torch.is_grad_enabled() and feats.requires_grad:
        return DotInteractionFn.apply(feats)
    return _forward(feats)


dot_interaction.launches = 0


def dot_interaction_bwd(feats: torch.Tensor,
                        grad: torch.Tensor) -> torch.Tensor:
    """Gradient of ``dot_interaction``: dx (B, F, D) in feats' type from
    the features and the triangle's gradient ``grad`` (B, F(F-1)/2).
    CUDA tensors launch the kernel (one block a sample, each thread a
    register tile of 7 output rows by 16 bytes of columns, sums in float32
    in a fixed order, no atomics; counted in
    ``dot_interaction_bwd.launches``); CPU tensors take
    ``dot_interaction_bwd_ref``."""
    _check(feats)
    B, F, D = feats.shape
    if grad.shape != (B, F * (F - 1) // 2) or grad.dtype != feats.dtype \
            or grad.device != feats.device:
        raise ValueError(f"grad must be ({B}, {F * (F - 1) // 2}) "
                         f"{feats.dtype} on {feats.device}, got "
                         f"{tuple(grad.shape)} {grad.dtype} {grad.device}")
    if feats.device.type == "cpu" and not is_fake(feats, grad):
        return dot_interaction_bwd_ref(feats, grad)
    if not (feats.is_contiguous() and grad.is_contiguous()):
        raise ValueError("feats and grad must be contiguous")
    refuse_grad("dot_interaction_bwd", feats, grad)
    if B > 2 ** 31 - 1:
        raise ValueError(f"dot_interaction_bwd indexes blocks with int32: "
                         f"B={B} is too large")
    if is_fake(feats, grad):
        fake_launch("dot_interaction_bwd", *cost(
            B, F, D, feats.element_size(), backward=True))
        return torch.empty_like(feats)
    smem = library_function("dot_interaction_bwd",
                            "dot_interaction_bwd_smem_bytes",
                            [ctypes.c_int] * 3,
                            restype=ctypes.c_longlong)(
        F, D, _DTYPES[feats.dtype])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"dot_interaction_bwd: F={F}, D={D} needs {smem} "
                         f"B of shared memory, more than a block has")
    fn = library_function(
        "dot_interaction_bwd", "dot_interaction_bwd_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    dx = torch.empty_like(feats)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = fn(feats.data_ptr(), grad.data_ptr(), dx.data_ptr(), B, F, D,
             _DTYPES[feats.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dot_interaction_bwd kernel launch failed: "
                           f"cudaError {err}")
    dot_interaction_bwd.launches += 1
    return dx


dot_interaction_bwd.launches = 0


def group_size(n_f: int, d: int, dtype: torch.dtype) -> int:
    """Samples the kernel stages and computes together for (F, D, dtype);
    the card tests choose B around it."""
    return library_function("dot_interaction", "dot_interaction_group",
                            [ctypes.c_int] * 3)(n_f, d, _DTYPES[dtype])
