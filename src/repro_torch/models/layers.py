"""Core neural layers as plain functions over parameter dicts.

Counterpart of ``repro.models.layers``. Parameters are nested dicts of
tensors; dense weights are ``(d_in, d_out)`` as in the reference, so a
JAX parameter pytree loads without transposes. Compute runs in the
config's ``dtype``; norms and RoPE compute in float32 and cast back.
The losses (``cross_entropy``, ``bce_with_logits``) compute in float32.
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
    """``std`` times a normal truncated to [-2, 2], as the reference;
    drawn in float32 and cast to ``dtype``, so a model built straight
    in bf16 holds one float32 tensor at a time, not a float32 copy of
    itself."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)


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
    with ``np.asarray``) as the same nesting of tensors on ``device``. A
    tensor leaf is kept as it is when it is already there."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_tensors(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree if device is None else tree.to(device)
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


def glu(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    """The gated product: ``silu(g) * u`` (SwiGLU) or ``gelu(g) * u`` with
    the tanh approximation (GeGLU, ``jax.nn.gelu(approximate=True)``)."""
    if act == "silu":
        return F.silu(g) * u
    if act == "gelu":
        return F.gelu(g, approximate="tanh") * u
    raise ValueError(f"unknown act {act!r}")


def glu_ffn_apply(p, x: torch.Tensor, act: str = "silu",
                  compute_dtype=None) -> torch.Tensor:
    """``down(act(gate(x)) * up(x))``: SwiGLU or GeGLU."""
    g = dense_apply(p["gate"], x, compute_dtype)
    u = dense_apply(p["up"], x, compute_dtype)
    return dense_apply(p["down"], glu(g, u, act), compute_dtype)


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


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)`` in float32, cast back to ``x``'s dtype."""
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def embed_apply(p, tokens: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return t[tokens.long()]


def unembed_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (tied) embedding table."""
    return x @ p["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-level CE with optional z-loss in float32; logits (..., V),
    labels (...,); with ``mask`` the masked mean (over at least 1)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    if mask is not None:
        mask = mask.to(torch.float32)
        return (loss * mask).sum() / mask.sum().clamp(min=1.0)
    return loss.mean()


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits, the reference's stable form."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


# ---------------------------------------------------------------------------
# Segment reductions in a fixed order
# ---------------------------------------------------------------------------

def _by_segment(data: torch.Tensor, segment_ids: torch.Tensor,
                n_segments: int):
    """Rows of ``data`` stably sorted by segment id, ids outside ``[0,
    n_segments)`` moved to a spare last segment (as ``segment_sum``
    drops them), and the rows a segment has, spare one included."""
    seg = segment_ids.reshape(-1).long()
    seg = torch.where((seg >= 0) & (seg < n_segments), seg,
                      torch.full_like(seg, n_segments))
    seg, order = torch.sort(seg, stable=True)
    return data[order], _counts(seg, n_segments + 1)


def _counts(seg: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(seg, minlength=n)`` for ids in [0, n): an integer
    scatter-add of fixed size n (a shape a fake-tensor trace can
    follow)."""
    return torch.zeros((n,), dtype=torch.int64, device=seg.device
                       ).scatter_add_(0, seg, torch.ones_like(seg))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: each segment's rows added in their order,
    one after another (``torch.segment_reduce`` over the stably sorted
    rows, no atomics: the same bits run after run on every device); an
    empty segment is 0."""
    rows, counts = _by_segment(data, segment_ids, n_segments)
    return torch.segment_reduce(rows, "sum", lengths=counts,
                                initial=0.0)[:n_segments]


class _SegmentMax(torch.autograd.Function):
    """``segment_reduce``'s max with JAX's gradient: a segment's output
    gradient split evenly over the rows that tie at its max.
    ``segment_reduce``'s own backward divides only positive gradients by
    the number of ties (a negative one reaches every tied row whole)."""

    @staticmethod
    def forward(ctx, data, segment_ids, n_segments):
        rows, counts = _by_segment(data, segment_ids, n_segments)
        out = torch.segment_reduce(rows, "max", lengths=counts)[:n_segments]
        ctx.save_for_backward(data, segment_ids, out)
        ctx.n_segments = n_segments
        return out

    @staticmethod
    def backward(ctx, grad):
        data, segment_ids, out = ctx.saved_tensors
        n = ctx.n_segments
        seg = segment_ids.reshape(-1).long()
        valid = ((seg >= 0) & (seg < n)).reshape(-1, *[1] * (data.dim() - 1))
        at = seg.clamp(0, n - 1)
        tied = valid & (data == out[at])
        ties = segment_sum(tied.to(grad.dtype), segment_ids, n)
        return (torch.where(tied, grad[at] / ties[at].clamp(min=1.0), 0.0),
                None, None)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: an empty segment is -inf; the gradient is
    split evenly over the rows that tie at a segment's max, as JAX's."""
    return _SegmentMax.apply(data, segment_ids, n_segments)


def segment_counts(segment_ids: torch.Tensor,
                   n_segments: int) -> torch.Tensor:
    """Rows in each segment (ids out of range not counted)."""
    seg = segment_ids.reshape(-1).long()
    keep = (seg >= 0) & (seg < n_segments)
    return _counts(torch.where(keep, seg, torch.full_like(
        seg, n_segments)), n_segments + 1)[:n_segments]
