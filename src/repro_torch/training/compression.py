"""Gradient compression: chunked int8 quantization with error feedback
(1-bit-Adam-family discipline, arXiv:2102.02888).

Counterpart of ``repro.training.compression``: ``_quant_leaf``,
``_dequant_leaf``, ``ef_init`` and ``compress_decompress`` (quantize ->
dequantize with error feedback, in the train step before the
optimizer). The codes round half to even, as ``jnp.round`` does, so
they equal the reference's. ``compressed_pod_mean`` is the explicit
form of the cross-pod mean: the int8 codes and float32 per-chunk scales
are all-gathered over a mesh axis (``pod``) of the ambient mesh
(``distribution.constraints.use_mesh``), then dequantised and averaged
on each rank, so the wire carries about 1 byte an element instead of 4.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.training.tree import leaves, tree_map, unflatten

CHUNK = 2048


def _quant_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk symmetric int8 quantization. Returns (q, scales)."""
    flat = g.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % CHUNK))
    chunks = flat.reshape(-1, CHUNK)
    scale = chunks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(chunks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                  dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def ef_init(grads_like: Any) -> Any:
    """Error-feedback residual state (zeros, float32)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


@torch.no_grad()
def compress_decompress(grads: Any, ef: Any) -> Tuple[Any, Any, Dict]:
    """Quantize and dequantize each leaf with error feedback. Returns
    (decompressed grads, new EF state, metrics ``ef_l1``)."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = _quant_leaf(corrected)
        deq = _dequant_leaf(q, s, g.shape, torch.float32)
        return deq.to(g.dtype), corrected - deq

    flat_g = leaves(grads)
    outs = [one(g, e) for g, e in zip(flat_g, leaves(ef))]
    err = sum(torch.sum(torch.abs(e)) for _, e in outs)
    total = sum(g.numel() for g in flat_g)
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]), {"ef_l1": err / total})


@torch.no_grad()
def compressed_pod_mean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Mean of ``x`` over the ranks of the ambient mesh's axis
    ``axis_name``, int8 on the wire. On an axis of one rank (or none)
    nothing is sent, but ``x`` is still quantised and dequantised, as
    the reference's."""
    from repro_torch.distribution.constraints import ambient_mesh
    from repro_torch.distribution.placement import all_gather, mesh_axes

    mesh = ambient_mesh()
    axes = [] if mesh is None else mesh_axes(mesh, [axis_name])
    q, s = _quant_leaf(x)
    qg = all_gather(q[None], axes, dim=0)        # (pods, chunks, CHUNK) i8
    sg = all_gather(s[None], axes, dim=0)        # (pods, chunks, 1) f32
    mean = (qg.to(torch.float32) * sg).mean(dim=0)
    return mean.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)
