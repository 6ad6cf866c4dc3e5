"""Core neural layers as plain functions over parameter dicts.

Counterpart of ``repro.models.layers``. Parameters are nested dicts of
tensors; dense weights are ``(d_in, d_out)`` as in the reference, so a
JAX parameter pytree loads without transposes. Compute runs in the
config's ``dtype``; norms and RoPE compute in float32 and cast back.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers (seeded with an explicit torch.Generator)
# ---------------------------------------------------------------------------

def trunc_normal(shape, std: float, generator: torch.Generator,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """``std`` times a normal truncated to [-2, 2], as the reference."""
    t = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std)


def dense_init(d_in: int, d_out: int, generator: torch.Generator, *,
               bias: bool = False, device=None, dtype=torch.float32,
               std: Optional[float] = None):
    p = {"w": trunc_normal((d_in, d_out),
                           std if std is not None else math.sqrt(1.0 / d_in),
                           generator, device, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def mlp_init(dims: Sequence[int], d_in: int, generator: torch.Generator, *,
             bias: bool = True, device=None, dtype=torch.float32):
    """A plain ReLU MLP ``d_in -> dims[0] -> ... -> dims[-1]``."""
    layers, d = [], d_in
    for h in dims:
        layers.append(dense_init(d, h, generator, bias=bias, device=device,
                                 dtype=dtype))
        d = h
    return {"layers": layers}


def rmsnorm_init(d: int, device=None, dtype=torch.float32):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_init(d: int, device=None, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def glu_ffn_init(d_model: int, d_ff: int, generator: torch.Generator, *,
                 device=None, dtype=torch.float32):
    kw = dict(device=device, dtype=dtype)
    return {"gate": dense_init(d_model, d_ff, generator, **kw),
            "up": dense_init(d_model, d_ff, generator, **kw),
            "down": dense_init(d_ff, d_model, generator, **kw)}


def embed_init(vocab: int, d_model: int, generator: torch.Generator, *,
               device=None, dtype=torch.float32):
    return {"table": trunc_normal((vocab, d_model), 0.02, generator,
                                  device, dtype)}


def to_tensors(tree, device=None):
    """A parameter pytree of numpy arrays (the reference's, converted
    with ``np.asarray``) as the same nesting of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_tensors(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def dense_apply(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def mlp_apply(p, x: torch.Tensor, final_act: bool = False,
              compute_dtype=None) -> torch.Tensor:
    n = len(p["layers"])
    for i, layer in enumerate(p["layers"]):
        x = dense_apply(layer, x, compute_dtype)
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: ``x / rms(x) * (1 + scale)`` in float32."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (biased variance, as
    ``jnp.var``), cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def glu_ffn_apply(p, x: torch.Tensor, act: str = "silu",
                  compute_dtype=None) -> torch.Tensor:
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""
    if act != "silu":
        raise ValueError(f"the port's FFN supports act='silu', got {act!r}")
    g = dense_apply(p["gate"], x, compute_dtype)
    u = dense_apply(p["up"], x, compute_dtype)
    return dense_apply(p["down"], F.silu(g) * u, compute_dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., seq, heads, d_head);
    positions: (..., seq)."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)              # (d_head/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, d/2)
    cos = torch.cos(ang)[..., :, None, :]                    # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_apply(p, tokens: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return t[tokens.long()]


def unembed_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (tied) embedding table."""
    return x @ p["table"].to(x.dtype).T
