"""The trust evaluators' scoring head: each position's log-probability of
its target token under the vocabulary head.

``score_head`` launches the hand-written CUDA kernel
(``csrc/score_head.cu``: the vocabulary product on ``wgmma`` from TMA
stages, an online log-sum-exp and the target's logit picked in
registers, so that no logit reaches device memory). It replaces no TPU
kernel: the JAX package leaves the head to XLA's fusion; the port's
plain path (``models.transformer._chunked_token_logprob``) writes every
logit, in bf16 and again in float32, and reads them four times more (see
the source's note).

``instance`` is the rule ``models.transformer`` applies to each call of
the head: a bf16 head of an unsharded vocabulary with no final softcap,
whose width is a multiple of 64 and at most ``MAX_WIDTH``, on the card,
takes the kernel (``"fused"``); everything else keeps the chunked
float32 log-softmax (``"chunked"``): gemma2's softcap, a vocabulary
sharded over a mesh axis, float32, CPU tensors and heads wider than
``MAX_WIDTH``. The kernel serves both layouts of the weight: a tied
embedding table (V, d) and an untied unembedding (d, V). A call the rule
sends to the kernel launches it or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (fake_launch, is_fake,
                                        library_function, misaligned,
                                        refuse_grad)

# d a stage of the kernel's product: the head's width must be a multiple
WIDTH_STEP = 64
# The widest head the kernel takes: the widest measured against the
# chunked path (qwen2.5-14b's step on an H100: 347-389 ms against 484-485,
# and faster at every width from 2048 up; see PERF.md's kernel table).
# The kernel's share of its bound falls as d grows (each block re-reads its
# 128 positions' x for every vocabulary tile) while the chunked path's
# float32 passes stay fixed a logit, so past this width the rule does not
# guess.
MAX_WIDTH = 5120


def instance(x: torch.Tensor, w: torch.Tensor, *, tied: bool,
             sharded: bool = False, softcap: float = 0.0,
             bias: bool = False) -> str:
    """The path a call of the head takes: ``"fused"`` (the kernel) or
    ``"chunked"`` (the chunked float32 log-softmax), from what the call
    can observe: x (P, d) on the card (a fake tensor stands for one) in
    bf16 with a bf16 weight, an unsharded vocabulary, no final logit
    softcap, no unembedding bias, d a multiple of ``WIDTH_STEP`` and at
    most ``MAX_WIDTH`` and, for an untied (d, V) weight, V a multiple of
    8 (TMA's 16-byte rows). A shape rule, not a fallback."""
    d = x.shape[-1]
    V = w.shape[0] if tied else w.shape[-1]
    on_card = x.device.type == "cuda" or is_fake(x)
    return ("fused" if on_card and x.dtype == torch.bfloat16
            and w.dtype == torch.bfloat16 and not sharded
            and softcap == 0.0 and not bias and d % WIDTH_STEP == 0
            and d <= MAX_WIDTH
            and (tied or V % 8 == 0) else "chunked")


def cost(P: int, d: int, V: int):
    """(operations, bytes) of one call: the (P, d) x (d, V) product (a
    multiply-add two operations); x and the weight read once in bf16, the
    int32 targets read and the float32 results written."""
    return 2 * P * d * V, P * (2 * d + 8) + 2 * d * V


def score_head(x: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor, *,
               tied: bool) -> torch.Tensor:
    """x: (P, d) bf16; w: (V, d) if ``tied`` else (d, V), bf16; tgt: (P,)
    integer ids in [0, V) -> (P,) float32 log-probabilities.

    Launches the kernel on CUDA tensors (counted in
    ``score_head.launches``); fake tensors report its operations and
    bytes instead. ``score_head.by_instance`` counts the head's calls by
    the path ``instance`` gave them (``models.transformer`` counts
    both)."""
    if x.dim() != 2 or w.dim() != 2 or tgt.dim() != 1:
        raise ValueError(f"x must be (P, d), w 2-d and tgt (P,), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(tgt.shape)}")
    P, d = x.shape
    V, dw = (w.shape if tied else w.shape[::-1])
    if dw != d or tgt.shape[0] != P:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"(tied={tied}) and tgt {tuple(tgt.shape)} do "
                         f"not agree")
    if x.device.type != "cuda" and not is_fake(x, w, tgt):
        raise ValueError(f"score_head runs on cuda, not {x.device}")
    refuse_grad("score_head", x, w)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"score_head's kernel takes bf16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if d % WIDTH_STEP or (not tied and V % 8):
        raise ValueError(f"score_head's kernel takes d a multiple of "
                         f"{WIDTH_STEP} and an untied V a multiple of 8, "
                         f"got d {d}, V {V}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("score_head takes contiguous x and w")
    if misaligned(x) or misaligned(w):
        raise ValueError("score_head takes x and w on 16-byte boundaries")
    tgt = tgt.to(torch.int32).contiguous()
    if is_fake(x, w, tgt):
        fake_launch("score_head", *cost(P, d, V))
        return torch.empty((P,), dtype=torch.float32, device=x.device)
    fn = library_function(
        "score_head", "score_head_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = torch.empty((P,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), tgt.data_ptr(), out.data_ptr(),
             P, d, V, int(not tied), stream)
    if err != 0:
        raise RuntimeError(f"score_head kernel launch failed: "
                           f"cudaError {err}")
    score_head.launches += 1
    return out


score_head.launches = 0
# the head's calls by the path ``instance`` gave them
score_head.by_instance = {"fused": 0, "chunked": 0}
