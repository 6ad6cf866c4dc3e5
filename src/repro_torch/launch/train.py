"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro.launch.train``: the smoke config (or with
``--full-config`` the published one) of any of the registry's ten
architectures, trained with the full stack (AdamW, accumulation,
compression, async fault-tolerant checkpoints, resume), printing the
reference's lines: ``arch=...``, one ``step ... loss ... lr ...`` line
per logged step and ``final loss ...``. Runs on the card (``cuda``)
unless ``--device cpu`` is given. The reference's mesh placement of the
state waits for the distribution slice (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch


def build(arch: str, *, full_config: bool = False, batch: int = 8,
          seq: int = 64, device=None, seed: int = 0
          ) -> Tuple[object, Dict, Callable, Iterator]:
    """(config, params, loss_fn(params, batch), data iterator) of the
    launcher's run of ``arch``: weights from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default cuda; raises without a card),
    data from the reference's streams (seed 1)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (GNNConfig, RecsysConfig,
                                          TransformerConfig)
    from repro_torch.device import resolve
    from repro_torch.training import data as D

    device = resolve(device)
    cfg = get_config(arch, smoke=not full_config)
    gen = torch.Generator(device=device).manual_seed(seed)
    if isinstance(cfg, TransformerConfig):
        from repro_torch.models import transformer as T
        params = T.init_params(cfg, gen, device=device)

        def loss_fn(p_, b):
            return T.lm_loss(p_, cfg, b["tokens"], b["labels"])
        data = D.lm_batches(cfg, batch, seq, seed=1)
    elif isinstance(cfg, RecsysConfig):
        from repro_torch.launch.steps import _recsys_loss
        M = _recsys_loss(cfg)
        params = M.init_params(cfg, gen, device=device)

        def loss_fn(p_, b):
            return M.loss_fn(p_, cfg, b)
        data = D.recsys_batches(cfg, batch, seed=1)
    elif isinstance(cfg, GNNConfig):
        from repro_torch.models import gnn as G
        params = G.init_params(cfg, gen, device=device)
        graph = D.synthetic_graph(512, 4096, cfg.d_feat, cfg.n_classes,
                                  seed=1)

        def loss_fn(p_, b):
            return G.node_loss(p_, cfg, b["x"], b["edge_index"],
                               b["labels"], b["train_mask"])

        def graph_iter():
            while True:
                yield graph
        data = graph_iter()
    else:
        raise SystemExit(f"unknown config type {type(cfg)}")
    return cfg, params, loss_fn, data


def opt_config(lr: float, steps: int):
    from repro_torch.training import optimizer as O
    return O.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                         total_steps=steps)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--compress", action="store_true")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--full-config", action="store_true",
                   help="use the published (non-smoke) config")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    from repro_torch.configs.registry import arch_ids
    from repro_torch.device import resolve
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import train_loop as TL
    from repro_torch.training.tree import leaves

    if args.arch not in arch_ids():
        print(f"unknown --arch {args.arch!r}; available: "
              f"{', '.join(arch_ids())}", file=sys.stderr)
        return 2
    dev = resolve(args.device)
    cfg, params, loss_fn, data = build(
        args.arch, full_config=args.full_config, batch=args.batch,
        seq=args.seq, device=dev)
    opt = opt_config(args.lr, args.steps)

    n_params = sum(x.numel() for x in leaves(params))
    print(f"arch={args.arch} ({'full' if args.full_config else 'smoke'}) "
          f"params={n_params / 1e6:.2f}M steps={args.steps}")

    step = TL.make_train_step(loss_fn, opt, grad_accum=args.grad_accum,
                              compress_grads=args.compress)
    state = TL.init_state(params, compress=args.compress)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CK.AsyncCheckpointer(args.ckpt_dir)
        if args.resume and CK.latest_step(args.ckpt_dir) is not None:
            state, extra = CK.restore(args.ckpt_dir, state)
            start = extra.get("step", 0)
            print(f"resumed at step {start}")

    state, hist = TL.train(state, step, data, n_steps=args.steps - start,
                           log_every=max(args.steps // 10, 1),
                           checkpointer=ckpt, ckpt_every=args.ckpt_every,
                           start_step=start)
    for h in hist:
        print(f"  step {h['step']:>5} loss {h['loss']:.4f} "
              f"lr {h['lr']:.2e}")
    ok = hist[-1]["loss"] < hist[0]["loss"] or len(hist) < 3
    print("final loss", round(hist[-1]["loss"], 4),
          "(improved)" if ok else "(flat — short run?)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
