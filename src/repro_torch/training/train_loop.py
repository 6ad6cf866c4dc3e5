"""Train-step factory: gradient accumulation, mixed precision, optional
gradient compression and metric plumbing, family-agnostic (the loss_fn
closes over the model).

Counterpart of ``repro.training.train_loop``. ``make_train_step`` keeps
the reference's ``grad_accum`` and ``compress_grads``; its JAX-only
``jit`` and ``donate`` arguments are gone (PyTorch runs eagerly, and
the optimizer updates the state in place: ``training.optimizer``). Each
microbatch's gradient comes from ``loss.backward()``; gradients are
summed in float32 and averaged over ``grad_accum``, as the reference's
``lax.scan``. A batch of numpy arrays is moved to the parameters'
device in the step.

``sync`` (a :class:`GradSync`) makes the step one rank's step of a
sharded training step (``launch.steps``' mesh cells): the loss is
backpropagated times ``scale``, the gradients and the loss are reduced
over the mesh by its callables, and the clipping norm is taken over
every rank's pieces. Without it the step is the replicated one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.training import compression as C
from repro_torch.training import optimizer as O
from repro_torch.training.tree import leaves, tree_map, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: O.AdamWState
    ef: Any                      # error-feedback state or None


class GradSync(NamedTuple):
    """How one rank's step joins the others' (see the module note)."""
    scale: float                 # the loss factor of the backward
    grads: Callable              # list of gradient leaves -> reduced list
    loss: Callable               # the rank's loss -> the reported loss
    norm_axes: Any               # per leaf, the axes it is a piece over


def init_state(params: Any, compress: bool = False) -> TrainState:
    return TrainState(params=params, opt=O.adamw_init(params),
                      ef=C.ef_init(params) if compress else None)


def to_device(batch: Dict, device) -> Dict:
    """Every array of ``batch`` as a tensor on ``device``."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v), device=device))
            for k, v in batch.items()}


def make_train_step(loss_fn: Callable[[Any, Dict], torch.Tensor],
                    opt_cfg: O.AdamWConfig, *, grad_accum: int = 1,
                    compress_grads: bool = False,
                    sync: Optional[GradSync] = None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar`` (may return (loss, aux)). With
    ``grad_accum > 1`` every leaf of ``batch`` has leading dim
    ``grad_accum`` (microbatches run in order, gradients averaged)."""

    def _loss(params, mb):
        out = loss_fn(params, mb)
        if isinstance(out, tuple):
            return out[0], out[1]
        return out, {}

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = state.params
        flat = leaves(params)
        for p in flat:
            if p.is_floating_point() and not p.requires_grad:
                p.requires_grad_(True)
        batch = to_device(batch, flat[0].device)
        acc = [None] * len(flat)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=flat[0].device)
        aux: Dict = {}
        for i in range(grad_accum):
            mb = batch if grad_accum == 1 else {k: v[i]
                                                for k, v in batch.items()}
            loss, aux = _loss(params, mb)
            (loss if sync is None else loss * sync.scale).backward()
            for j, p in enumerate(flat):
                g = (p.grad if p.grad is not None
                     else torch.zeros_like(p)).to(torch.float32)
                acc[j] = g if acc[j] is None else acc[j].add_(g)
                p.grad = None
            loss_sum = loss_sum + loss.detach().to(torch.float32)
        if grad_accum == 1:
            loss = loss_sum
        else:
            acc = [g.div_(grad_accum) for g in acc]
            loss = loss_sum / grad_accum
            aux = {}
        if sync is not None:
            acc = sync.grads(acc)
            loss = sync.loss(loss)
        grads = unflatten(params, acc)

        ef = state.ef
        metrics: Dict[str, torch.Tensor] = {"loss": loss}
        if compress_grads:
            grads, ef, cm = C.compress_decompress(grads, ef)
            metrics.update(cm)
        new_params, new_opt, om = O.adamw_update(
            grads, state.opt, params, opt_cfg,
            None if sync is None else sync.norm_axes)
        metrics.update(om)
        for k, v in (aux.items() if isinstance(aux, dict) else []):
            metrics[f"aux/{k}"] = v.detach()
        return TrainState(new_params, new_opt, ef), metrics

    return step


def train(state: TrainState, step_fn: Callable, data_iter,
          n_steps: int, *, log_every: int = 10,
          checkpointer=None, ckpt_every: int = 0,
          start_step: int = 0, hooks=()) -> Tuple[TrainState, list]:
    """Simple training driver with checkpoint hooks; returns history."""
    history = []
    for i in range(start_step, start_step + n_steps):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
        if checkpointer is not None and ckpt_every and \
                (i + 1) % ckpt_every == 0:
            checkpointer.save(i + 1, state,
                              extra={"step": i + 1})
        for h in hooks:
            h(i, state, metrics)
    if checkpointer is not None:
        checkpointer.wait()
    return state, history
