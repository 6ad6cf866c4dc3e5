#!/usr/bin/env python3
"""Sweep a cell's open-loop rate on the chip, to find the rate its
traffic file fixes (the knee, or the sustained rate of trusted items).

    python3 portbench/sweep.py --workload <name> --rates 80,120,160 \
        --seconds 20 --seed <n>

Runs the cell once at each rate in one process (the traffic file's
``rate_per_s`` replaced) and prints one JSON line a rate: the offered
and answered rates, the tail, the shares, the backlog left at the close
and the load monitor's Ucapacity over the window's steps.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import CACHE, ROOT  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args()
    import os
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness, readers
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = harness.cell_files(manifest, args.workload)
    if not torch.cuda.is_available():
        print("no NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = T_START
    for rate in [float(r) for r in args.rates.split(",")]:
        files = copy.deepcopy(base)
        files["traffic"]["rate_per_s"] = rate
        sink = {}
        line = harness.run(files, args.seed, args.seconds, False, dev,
                           t_start, {}, sink=sink)
        obs = sink["obs"]
        ucap = [s[0] for s in sink["steps"][-max(sink["window_steps"], 1):]]
        n_items = sum(obs["admitted_tiers"].values())
        print(json.dumps({
            "workload": args.workload, "rate_per_s": rate,
            "correct": line["correct"],
            "p50_s": readers.p_nearest(obs["latency_s"], 0.5),
            "p95_s": readers.p_nearest(obs["latency_s"], 0.95),
            "trusted_items_per_s": obs["trusted_items"] / args.seconds,
            "eval_items_per_s": obs["eval_items"] / args.seconds,
            "admitted_items": n_items, "requests": obs["n_requests"],
            "reject_pct": 100.0 * obs["n_rejected"] / obs["n_requests"],
            "prior_pct": readers.tier_share(obs, 2),
            "hit_pct": readers.tier_share(obs, 1),
            "batch_fill": obs["batch_fill"],
            "steps_per_s": sink["window_steps"] / args.seconds,
            "backlog_items_at_close": sink["backlog_end"],
            "ucap_first_last": [ucap[0], ucap[-1]] if ucap else None,
            "setup_s": sink["setup_s"],
            "checks": {k: v["value"] for k, v in line["checks"].items()}}),
            flush=True)
        t_start = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
