"""AdamW, learning-rate schedules and global-norm clipping over parameter
trees.

Counterpart of ``repro.training.optimizer``. The state mirrors the
parameter tree (m, v) plus a step counter; master weights stay in the
parameter dtype (float32 by default) and the optimizer math is float32,
so mixed-precision training keeps float32 updates while compute runs in
bf16.

Unlike the reference, which returns new arrays, ``adamw_update`` writes
the new parameters, m and v **in place** into the tensors it is given
(and scales the gradients in place when it clips): the full-width DLRM's
12.3 GB of tables would not fit a second copy of each. It returns those
same tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.training.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"          # "cosine" | "constant"


def adamw_init(params: Any) -> AdamWState:
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves(params)[0].device),
                      m=tree_map(torch.zeros_like, params),
                      v=tree_map(torch.zeros_like, params))


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (or constant),
    in float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any, axes=None) -> torch.Tensor:
    """The L2 norm over every leaf. ``axes`` (optional, one list of
    ``distribution.placement.Axis`` per leaf) names the mesh axes a leaf
    is a piece over: the squares of the leaves of one set of axes are
    summed over those ranks, so that every rank gets the norm of the
    whole tree."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)]
    if not axes or not any(axes):
        return torch.sqrt(sum(sq))
    from repro_torch.distribution.placement import all_reduce
    groups: Dict[tuple, list] = {}
    for s, ax in zip(sq, axes):
        groups.setdefault(tuple(a.name for a in ax), [ax, []])[1].append(s)
    total = sum(all_reduce(sum(ss), ax) if ax else sum(ss)
                for ax, ss in groups.values())
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float, axes=None
                        ) -> Tuple[Any, torch.Tensor]:
    """Scales every leaf by min(1, max_norm / norm), in place where a
    leaf is float32 (``axes`` as ``global_norm``'s). Returns (grads,
    norm)."""
    norm = global_norm(grads, axes)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.mul_(scale.to(g.dtype)), grads), norm


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 cfg: AdamWConfig, norm_axes=None
                 ) -> Tuple[Any, AdamWState, Dict]:
    """Returns (new_params, new_state, metrics ``lr``, ``grad_norm``);
    see the module note: params, m and v are updated in place. On a
    rank's pieces of a sharded tree, ``norm_axes`` (``global_norm``'s
    ``axes``) makes the clipping norm the whole tree's."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm_axes)
    else:
        gnorm = global_norm(grads, norm_axes)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, m, v, g):
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        return p

    new_params = tree_map(upd, params, state.m, state.v, grads)
    return new_params, AdamWState(step=step, m=state.m, v=state.v), {
        "lr": lr, "grad_norm": gnorm}
